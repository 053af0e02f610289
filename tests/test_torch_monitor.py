"""The port's monitor-driven gateway actions, as ``tests/test_monitor.py``
checks them on the reference: tamper-storm quarantine, proactive spill and
nonce-lane renonce never change an honest tenant's tokens, and every
decision lands in the verified audit chain.

The ground truth is the port's own fixed-slot engine with security off
(itself held against the reference engine in test_torch_serve_engine.py);
granite-3-2b smoke config, float32, weights from a seeded generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.channel import SecureChannel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs import MonitorConfig  # noqa: E402
from repro_torch.serve import SecureGateway, ServeEngine  # noqa: E402
from repro_torch.serve import TenantQuarantined  # noqa: E402
from repro_torch.serve.gateway import PROVIDER  # noqa: E402

torch.set_num_threads(1)

PAGE = 8
MAXP = 4
N_NEW = 5
PROMPT_LENS = {"alice": 6, "bob": 9, "carol": 12}


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = {t: rng.randint(0, cfg.vocab, n).astype(np.int32)
               for t, n in PROMPT_LENS.items()}
    return cfg, params, prompts


@pytest.fixture(scope="module")
def reference(setup):
    cfg, params, prompts = setup
    eng = ServeEngine(cfg=cfg, params=params,
                      channel=SecureChannel.insecure(device="cpu"),
                      max_len=PAGE * MAXP)
    return {t: eng.generate({"tokens": p[None]}, n_new=N_NEW)[0]
            for t, p in prompts.items()}


def gateway(setup, **monitor):
    cfg, params, _ = setup
    return SecureGateway(cfg, params, security="trusted", max_slots=3,
                         page_size=PAGE, n_pages=32, max_pages_per_seq=MAXP,
                         monitor_config=MonitorConfig(**monitor),
                         device="cpu")


def test_tamper_storm_quarantines_only_the_offending_tenant(setup,
                                                            reference):
    cfg, _, prompts = setup
    gw = gateway(setup, tamper_storm_count=2, tamper_storm_window=64,
                 cooldown_steps=4)
    rng = np.random.RandomState(7)
    mallory = [gw.submit("mallory", rng.randint(0, cfg.vocab, 7),
                         max_new=N_NEW) for _ in range(2)]
    honest = {t: gw.submit(t, prompts[t], max_new=N_NEW)
              for t in ("alice", "bob")}
    gw.step()
    for rid in mallory:
        gw.pool.k_ct[gw.scheduler.requests[rid].pages[0], 0, 0, 0, 0] += 1
    gw.drain()
    assert gw.monitor.alerts_of("tamper_storm", tenant="mallory")
    assert gw.quarantined() == ["mallory"]
    assert [gw.status(rid) for rid in mallory] == ["poisoned"] * 2
    with pytest.raises(TenantQuarantined):
        gw.submit("mallory", rng.randint(0, cfg.vocab, 5), max_new=2)
    for t, rid in honest.items():
        assert gw.status(rid) == "done"
        np.testing.assert_array_equal(gw.collect(rid), reference[t])
    assert [r["tenant"] for r in gw.audit.records_of("quarantine")] == \
        ["mallory"]
    assert gw.verify_audit()["ok"]
    assert gw.release_quarantine("mallory")
    rid = gw.submit("mallory", rng.randint(0, cfg.vocab, 5), max_new=2)
    gw.drain()
    assert gw.status(rid) == "done" and gw.verify_audit()["ok"]


def test_occupancy_alert_drives_proactive_spill(setup, reference):
    _, _, prompts = setup
    gw = gateway(setup, occupancy_high_pct=5.0, occupancy_window=2,
                 cooldown_steps=8)
    rids = {t: gw.submit(t, p, max_new=N_NEW) for t, p in prompts.items()}
    gw.drain()
    assert gw.monitor.alerts_of("occupancy_watermark")
    spills = gw.audit.records_of("proactive_spill")
    assert spills and gw.metrics()["swap_outs"] >= len(spills)
    for t, rid in rids.items():
        assert gw.status(rid) == "done"
        np.testing.assert_array_equal(gw.collect(rid), reference[t])
    assert gw.verify_audit()["ok"]


def test_nonce_headroom_alert_renonces_open_pages(setup, reference):
    _, _, prompts = setup
    gw = gateway(setup, nonce_headroom_min=9, cooldown_steps=8)
    rids = {t: gw.submit(t, p, max_new=N_NEW) for t, p in prompts.items()}
    gw.drain()
    assert gw.monitor.alerts_of("nonce_headroom")
    renonces = gw.audit.records_of("page_renonce")
    assert renonces and all(r["detail"]["ok"] for r in renonces)
    assert gw.audit.records_of("nonce_refresh")
    for t, rid in rids.items():
        assert gw.status(rid) == "done"
        np.testing.assert_array_equal(gw.collect(rid), reference[t])
    assert gw.verify_audit()["ok"]


def test_manual_quarantine_refuses_provider(setup):
    _, _, prompts = setup
    cfg, params, _ = setup
    gw = SecureGateway(cfg, params, security="trusted", max_slots=2,
                       page_size=PAGE, n_pages=32, max_pages_per_seq=MAXP,
                       monitor=False, device="cpu")
    assert gw.monitor is None
    with pytest.raises(ValueError):
        gw.quarantine(PROVIDER)
    rid = gw.submit("alice", prompts["alice"], max_new=2)
    gw.quarantine("alice", reason="operator")
    assert gw.status(rid) == "quarantined"
    with pytest.raises(TenantQuarantined):
        gw.submit("alice", prompts["alice"], max_new=2)
    assert not gw.release_quarantine("bob")
    assert gw.release_quarantine("alice")
