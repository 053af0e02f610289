"""The port's PagedEngine with whole-page decode reseals (open_pages=False)
against the JAX engine: same script, same harness as test_torch_engine.py.
"""
import pytest

pytest.importorskip("torch")

from test_torch_engine import MAX_NEW, SIDES, run_pair  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    return run_pair(open_pages=False)


def test_legacy_token_streams_equal_reference(runs):
    assert runs["jax"]["tokens"] == runs["torch"]["tokens"]
    assert all(len(t) == MAX_NEW for t in runs["torch"]["tokens"].values())


def test_legacy_sealed_byte_accounting_equals_reference(runs):
    assert runs["jax"]["stats"] == runs["torch"]["stats"]
    ts = runs["torch"]["stats"]
    assert ts["page_closes"] == 0
    # every decode token reseals a whole k and v page
    page_bytes = runs["torch"]["engine"].pool.page_bytes
    assert ts["sealed_bytes_decode"] == ts["decode_tokens"] * 2 * page_bytes
    assert set(runs) == set(SIDES)
