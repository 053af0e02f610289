"""Plain torch version of the CTR kernel (bit-exact, int64 arithmetic)."""
from __future__ import annotations

import torch

from .. import common


def keystream_rows(tkeys: torch.Tensor, rows: torch.Tensor,
                   n_elems: int, elem_bytes: int) -> torch.Tensor:
    """int64 keystream [N, R, n_elems] in [0, 2**(8*elem_bytes)).

    tkeys int32[N, 2]; rows int64[N, R] counter rows.  Element e of a row
    takes half e % 2 of word e // 2 for 16-bit elements.
    """
    epw = 4 // elem_bytes
    n_words = -(-n_elems // epw)
    nb = (n_words + 1) // 2
    k = common.u32(tkeys)
    blocks = torch.arange(nb, dtype=torch.int64, device=rows.device)
    y0, y1 = common.threefry2x32(k[:, 0, None, None], k[:, 1, None, None],
                                 rows[:, :, None], blocks[None, None, :])
    words = torch.stack([y0, y1], dim=-1).reshape(*rows.shape, 2 * nb)
    words = words[..., :n_words]
    if epw == 1:
        return words
    shifts = torch.tensor([0, 16], dtype=torch.int64, device=rows.device)
    halves = (words[..., None] >> shifts) & common.M16
    return halves.reshape(*rows.shape, 2 * n_words)[..., :n_elems]


def ctr_xor_ref(x: torch.Tensor, tkeys: torch.Tensor,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """x int16/int32 [N, R, E]; tkeys int32 [N, 2]; rows int32 [N, R] or
    None (row r is r).  Returns x XOR keystream, same dtype."""
    N, R, E = x.shape
    if rows is None:
        rows = torch.arange(R, dtype=torch.int64,
                            device=x.device).expand(N, R)
    else:
        rows = common.u32(rows)
    ks = keystream_rows(tkeys, rows, E, x.element_size())
    cast = common.i32 if x.dtype == torch.int32 else common.i16
    return x ^ cast(ks)
