"""The port's observability tools (``tools/*_torch.py``) against the
reference's (``tools/verify_audit.py``, ``obs_dash.py``,
``trace2perfetto.py``), on the CPU.

Each side's gateway serves granite-3-2b's smoke config with a trace on and
exports its audit log (+ verification key), its trace as JSONL and its
Prometheus metrics: the port's gateway sealed, the reference's with
security off (its sealed gateway compiles for minutes here; its audit log
chains the same sessions, steps and requests either way).  On both
exports the port's tools and the reference's give the same exit codes and
the same output, so the formats are the same: ``verify_audit_torch``
exits 0 on an intact log, 1 on one record edited, 2 on the trailer
stripped and 3 on an empty key file.
"""
import contextlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.obs import dash as jdash  # noqa: E402
from repro.obs import jsonl_to_chrome  # noqa: E402
from repro.serve import SecureGateway as JGateway  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.serve import SecureGateway as TGateway  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = ("torch", "jax")


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOLS = {name: {"torch": load_tool(f"{name}_torch"), "jax": load_tool(name)}
         for name in ("verify_audit", "obs_dash", "trace2perfetto")}


def gateway(side: str):
    kw = dict(max_slots=2, page_size=8, n_pages=16, max_pages_per_seq=3,
              trace=True)
    if side == "torch":
        cfg = tconfigs.get_config("granite-3-2b", smoke=True)
        params = tregistry.get_model(cfg).init(
            torch.Generator().manual_seed(0), cfg, "cpu")
        return TGateway(cfg, params, security="trusted", device="cpu", **kw)
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    params = jregistry.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return JGateway(cfg, params, security="off", **kw)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{side: {"audit", "key", "trace", "metrics"}: paths}."""
    out = {}
    for side in SIDES:
        d = tmp_path_factory.mktemp(f"obs_{side}")
        gw = gateway(side)
        rng = np.random.RandomState(3)
        for i, n in enumerate((5, 11, 7)):
            gw.submit(f"tenant-{i % 2}", rng.randint(0, 512, n), max_new=4)
        gw.drain()
        paths = {"audit": d / "audit.jsonl", "key": d / "audit.jsonl.key",
                 "trace": d / "trace.jsonl", "metrics": d / "metrics.prom"}
        assert gw.export_audit(str(paths["audit"]),
                               key_path=str(paths["key"])) > 0
        assert gw.export_trace(str(paths["trace"]), fmt="jsonl") > 0
        paths["metrics"].write_text(gw.metrics_text())
        out[side] = paths
    return out


def run_tool(mod, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def damaged(paths: dict, case: str, d: pathlib.Path) -> tuple[str, str]:
    """(log, key) paths of the export with one kind of damage."""
    lines = paths["audit"].read_text().splitlines()
    log, key = d / f"{case}.jsonl", paths["key"]
    if case == "edited":
        rec = json.loads(lines[1])
        rec["kind"] = rec["kind"] + "-edited"
        lines[1] = json.dumps(rec, sort_keys=True)
    elif case == "trailer":
        assert json.loads(lines[-1])["kind"] == "_trailer"
        lines = lines[:-1]
    elif case == "key":
        key = d / "empty.key"
        key.write_text("")
    log.write_text("\n".join(lines) + "\n")
    return str(log), str(key)


@pytest.mark.parametrize("case,code", [("intact", 0), ("edited", 1),
                                       ("trailer", 2), ("key", 3)])
def test_verify_audit_exit_codes(exports, tmp_path, case, code):
    """The port's tool on the port's export; the reference's tool on the
    same files gives the same code and the same report line."""
    log, key = damaged(exports["torch"], case, tmp_path)
    got = run_tool(TOOLS["verify_audit"]["torch"], [log, key])
    assert got[0] == code
    assert got == run_tool(TOOLS["verify_audit"]["jax"], [log, key])
    assert run_tool(TOOLS["verify_audit"]["torch"],
                    [log, key, "--quiet"]) == (code, "")


@pytest.mark.parametrize("tool_side,export_side", [("jax", "torch"),
                                                   ("torch", "jax")])
def test_each_verifier_accepts_the_other_packages_export(exports, tool_side,
                                                         export_side):
    p = exports[export_side]
    rc, out = run_tool(TOOLS["verify_audit"][tool_side],
                       [str(p["audit"]), str(p["key"])])
    assert rc == 0 and "chain + trailer verify" in out


@pytest.mark.parametrize("side", SIDES)
def test_trace2perfetto_gives_the_reference_object(exports, tmp_path, side):
    src, dst = str(exports[side]["trace"]), tmp_path / "trace.json"
    rc, out = run_tool(TOOLS["trace2perfetto"]["torch"], [src, str(dst)])
    with open(src) as f:
        want = jsonl_to_chrome(f)
    got = json.loads(dst.read_text())
    assert rc == 0 and got == want and len(got["traceEvents"]) > 0
    assert out.startswith(f"{dst}: {len(want['traceEvents'])} events")
    assert run_tool(TOOLS["trace2perfetto"]["torch"], [])[0] == 2


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("extra", [[], ["--slo", "ttft_p95_ms=250",
                                         "--tail", "3"]],
                         ids=["default", "slo_tail"])
def test_obs_dash_renders_the_reference_text(exports, side, extra):
    p = exports[side]
    argv = [str(p["metrics"]), str(p["audit"])] + extra
    rc, out = run_tool(TOOLS["obs_dash"]["torch"], argv)
    assert rc == 0 and "== secure-gateway posture ==" in out
    assert (rc, out) == run_tool(TOOLS["obs_dash"]["jax"], argv)
    if not extra:
        want = jdash.render(jdash.parse_prometheus(p["metrics"].read_text()),
                            jdash.load_audit_jsonl(str(p["audit"])))
        assert out == want + "\n"


def test_obs_dash_refuses_a_bad_slo(exports):
    p = exports["torch"]
    with contextlib.redirect_stderr(io.StringIO()):
        rc = TOOLS["obs_dash"]["torch"].main(
            [str(p["metrics"]), "--slo", "ttft_p95_ms"])
    assert rc == 2
