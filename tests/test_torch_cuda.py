"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device, and runs
on a machine with an NVIDIA Hopper card (the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ctr_cipher import ops as ctr_ops  # noqa: E402
from repro_torch.kernels.ctr_cipher import ref as ctr_ref  # noqa: E402
from repro_torch.kernels.tree_mac import ops as mac_ops  # noqa: E402
from repro_torch.kernels.tree_mac import ref as mac_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def bits(gen, shape, dtype):
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                      dtype=torch.int64)
    return x.to(dtype)


@pytest.mark.parametrize("n, r, e, dtype, rows", [
    (1, 256, 256, torch.int32, False), (3, 300, 200, torch.int32, True),
    (2, 7, 49155, torch.int16, False), (4, 320, 64, torch.int16, True),
    (1, 5, 9, torch.int16, True)])
def test_ctr_kernel_matches_plain_version(gen, n, r, e, dtype, rows):
    x = bits(gen, (n, r, e), dtype)
    tkeys = bits(gen, (n, 2), torch.int32)
    rw = bits(gen, (n, r), torch.int32) if rows else None
    before = ctr_ops.ctr_xor.launches
    out = ctr_ops.ctr_xor(x, tkeys, rw)
    torch.cuda.synchronize()
    assert ctr_ops.ctr_xor.launches == before + 1
    assert torch.equal(out, ctr_ref.ctr_xor_ref(x, tkeys, rw))


@pytest.mark.parametrize("n, r, e, dtype, cw", [
    (1, 256, 512, torch.int32, 128), (1, 4, 49155, torch.int16, 2),
    (8, 1, 163840, torch.int16, 128), (3, 5, 24, torch.int32, 3)])
def test_tree_mac_kernel_matches_plain_version(gen, n, r, e, dtype, cw):
    x = bits(gen, (n, r, e), dtype)
    keys = (bits(gen, (n, cw), torch.int64) & 0x7FFFFFFE).to(torch.int32)
    before = mac_ops.mac_tags.launches
    out = mac_ops.mac_tags(x, keys)
    torch.cuda.synchronize()
    assert mac_ops.mac_tags.launches == before + 1
    assert torch.equal(out, mac_ref.mac_tags_ref(x, keys, cw))
    assert np.all(out.cpu().numpy() >= 0)
