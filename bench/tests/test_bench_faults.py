"""A whole run of each cell on the CPU at the configurations' small sizes,
past the harness's look for a card: sound, ``correct`` comes out true;
with the timed path broken underneath, false.  The faults are each one a
cell can have: for serving, a token altered where it is produced; for
training, a step that returns its state unchanged and half of the batch
left out, the mean taken over the rest."""
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchlib import harness
from benchlib.cell import Cell

ROOT = Path(__file__).resolve().parents[2]

SERVE = dict(tenants=2, clients_per_tenant=2, block=4,
             prompt={"dist": "log_uniform", "min": 20, "max": 60},
             engine={"max_slots": 4, "page_size": 16, "max_pages_per_seq": 8,
                     "prefill_chunk": 32, "chunk_words": 128},
             warmup=[[47, 3]], trace_steps=[2, 2], check_tokens=20)


def _run(workload: str, seed: int, seconds: float = 3.0, **traffic):
    cell = Cell.load(ROOT, workload)
    cell.traffic.update(traffic)
    ctx = harness.Ctx(seed=seed, seconds=seconds, trace=False, device="cpu",
                      smoke=True)
    rc, out = harness.run(cell, ctx, time.monotonic())
    assert rc == 0
    return out


def test_serving_sound_is_correct():
    out = _run("granite-serve-code", 2**33 + 7, seconds=8.0, **SERVE)
    assert out["correct"] and out["attempted"] > 0
    assert list(out["checks"]) == ["served_logit_gap"]
    assert list(out)[-1] == "checks"


def test_serving_token_altered_is_not_correct(monkeypatch):
    from repro_torch.serve.engine import PagedEngine

    real = PagedEngine.decode_step

    def altered(self, tokens, seq_lens, active, page_tables, write_pp):
        tok, ok = real(self, tokens, seq_lens, active, page_tables, write_pp)
        tok = np.where(np.asarray(active), (tok + self.cfg.vocab // 2)
                       % self.cfg.vocab, tok).astype(tok.dtype)
        return tok, ok

    monkeypatch.setattr(PagedEngine, "decode_step", altered)
    out = _run("granite-serve-code", 2**33 + 7, seconds=8.0, **SERVE)
    assert out["attempted"] > 0
    assert not out["correct"]


def _broken_step(monkeypatch, how: str):
    from repro_torch.core import sealed as sealed_lib
    from repro_torch.train import trainer

    real = trainer.make_train_step

    def make(model, cfg, opt, sec, key, **kw):
        step = real(model, cfg, opt, sec, key, **kw)

        def unchanged(state, batch):
            params, ok = sealed_lib.unseal_tree(state.params, key)
            mb = {k: v[0] for k, v in batch.items()}
            with torch.no_grad():
                loss = model.loss(params, cfg, mb)
            return state, {"loss": loss, "seal_ok": ok}

        def half(state, batch):
            n, rows = batch["tokens"].shape[:2]
            cut = ({k: v[:, :rows // 2] for k, v in batch.items()} if rows > 1
                   else {k: v[:max(1, n // 2)] for k, v in batch.items()})
            return step(state, cut)

        return {"unchanged": unchanged, "half": half, "sound": step}[how]

    monkeypatch.setattr(trainer, "make_train_step", make)


@pytest.mark.parametrize("how", ["sound", "unchanged", "half"])
def test_training_faults_are_not_correct(how, monkeypatch):
    _broken_step(monkeypatch, how)
    out = _run("granite-train-8k", 2**32 + 11, seconds=1.0, seq_len=32)
    assert out["correct"] == (how == "sound"), out["checks"]
