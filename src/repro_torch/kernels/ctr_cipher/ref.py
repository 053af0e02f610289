"""Plain torch version of the CTR kernel (bit-exact, int64 arithmetic)."""
from __future__ import annotations

import torch

from .. import common


def keystream_rows(tkeys: torch.Tensor, rows: torch.Tensor,
                   n_elems: int, elem_bytes: int,
                   col0: int = 0) -> torch.Tensor:
    """int64 keystream [N, R, n_elems] in [0, 2**(8*elem_bytes)) of the
    columns col0 ... col0 + n_elems - 1 of the counter rows.

    tkeys int32[N, 2]; rows int64[N, R] counter rows.  Element e of a row
    takes half e % 2 of word e // 2 for 16-bit elements.
    """
    epw = 4 // elem_bytes
    b0, lead = divmod(col0, 2 * epw)       # the first block, elements before
    nb = -(-(lead + n_elems) // (2 * epw))
    k = common.u32(tkeys)
    blocks = b0 + torch.arange(nb, dtype=torch.int64, device=rows.device)
    y0, y1 = common.threefry2x32(k[:, 0, None, None], k[:, 1, None, None],
                                 rows[:, :, None], blocks[None, None, :])
    words = torch.stack([y0, y1], dim=-1).reshape(*rows.shape, 2 * nb)
    if epw == 2:
        shifts = torch.tensor([0, 16], dtype=torch.int64, device=rows.device)
        words = ((words[..., None] >> shifts) & common.M16).reshape(
            *rows.shape, 4 * nb)
    return words[..., lead:lead + n_elems]


def ctr_xor_ref(x: torch.Tensor, tkeys: torch.Tensor,
                rows: torch.Tensor | None = None,
                col0: int = 0) -> torch.Tensor:
    """x int16/int32 [N, R, E]; tkeys int32 [N, 2]; rows int32 [N, R] or
    None (row r is r); col0: x's first column in its counter rows.
    Returns x XOR keystream, same dtype."""
    N, R, E = x.shape
    if rows is None:
        rows = torch.arange(R, dtype=torch.int64,
                            device=x.device).expand(N, R)
    else:
        rows = common.u32(rows)
    ks = keystream_rows(tkeys, rows, E, x.element_size(), col0)
    cast = common.i32 if x.dtype == torch.int32 else common.i16
    return x ^ cast(ks)
