"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``), the
smoke config, both engines; without ``--device`` it asks for the card."""
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


def test_serve_main_audit_chain(capsys, tmp_path):
    path = str(tmp_path / "audit.jsonl")
    serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--requests",
                "2", "--max-new", "3", "--audit", path])
    assert "chain OK" in capsys.readouterr().out


def test_serve_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-3-2b", "--requests", "1"])
