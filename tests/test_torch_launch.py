"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``), the
smoke configs, both engines and every ported family; without ``--device``
it asks for the card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("extra, want", [
    ([], "swap out/in"),
    (["--hi-every", "2", "--whole-page-reseal"], "launches verified"),
    (["--engine", "fixed"], "tokens in"),
    (["--engine", "fixed", "--security", "off"], "launches verified: 0")])
def test_serve_main_on_cpu(capsys, extra, want):
    serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--tenants", "2",
                "--requests", "3", "--max-new", "4", *extra])
    out = capsys.readouterr().out
    assert want in out
    if "fixed" not in extra:
        assert out.count("(done") == 3


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "internvl2-2b",
                                  "moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b",
                                  "seamless-m4t-large-v2"])
def test_serve_main_other_families_on_cpu(capsys, arch):
    """No paged path: the gateway engine says so and serves through the
    fixed-slot engine (the VLM's 8 patch tokens counted in its cache; the
    encoder-decoder's frame embeddings as long as the prompt)."""
    serve.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no paged path yet; falling back to the fixed-slot engine" in out
    assert "4 x 12 tokens in" in out and "launches verified: 12" in out


def test_serve_main_audit_chain(capsys, tmp_path):
    path = str(tmp_path / "audit.jsonl")
    serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--requests",
                "2", "--max-new", "3", "--audit", path])
    assert "chain OK" in capsys.readouterr().out


def test_serve_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-3-2b", "--requests", "1"])
