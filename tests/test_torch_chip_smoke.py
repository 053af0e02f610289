"""chip_smoke.py's own arithmetic, on the CPU (the script's run needs the
card): the device-busy sum of a profile, the sealed-attention bound, and
the refusal to run without a card."""
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_device_busy_counts_each_kernel_once():
    """A CPU operator's row repeats the device time of the kernels it
    launched; only the kernel rows add up to the busy time."""
    rows = [types.SimpleNamespace(device_type=DeviceType.CPU,
                                  self_device_time_total=5.0),
            types.SimpleNamespace(device_type=DeviceType.CUDA,
                                  self_device_time_total=5.0),
            types.SimpleNamespace(device_type=DeviceType.CUDA,
                                  self_device_time_total=3.0)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    kept = chip_smoke.device_events(prof)
    assert sum(e.self_device_time_total for e in kept) == 8.0


def _raw(device_type, name, ns):
    return types.SimpleNamespace(device_type=lambda: device_type,
                                 name=lambda: name, duration_ns=lambda: ns)


def test_kernel_rows_sum_the_device_events_by_name():
    """``kernel_rows`` keeps the raw events of the device, by name, and
    drops the CPU's (operators and runtime calls)."""
    events = [_raw(DeviceType.CPU, "aten::mul", 9_000_000),
              _raw(DeviceType.CUDA, "k", 2_000_000),
              _raw(DeviceType.CUDA, "k", 1_000_000),
              _raw(DeviceType.CUDA, "Memcpy DtoH", 500_000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert chip_smoke.kernel_rows(prof) == {"k": [2, 3.0],
                                            "Memcpy DtoH": [1, 0.5]}


@pytest.mark.cuda
def test_kernel_rows_equal_key_averages_on_the_card():
    """On the card, one profiled run read both ways: ``kernel_rows`` gives
    the launches and device time of ``key_averages``' device rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the profiler traces the card)")
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            x.mul_(1.0001)
        x.cpu()
        torch.cuda.synchronize()
    rows = chip_smoke.kernel_rows(prof)
    events = chip_smoke.device_events(prof)
    assert sum(n for n, _ in rows.values()) == sum(e.count for e in events)
    assert sum(n for n, _ in rows.values()) >= 201
    assert sum(ms for _, ms in rows.values()) == pytest.approx(
        sum(e.self_device_time_total for e in events) / 1e3, rel=1e-6)


@pytest.mark.parametrize("verify, ops", [(False, 155_189_248),
                                         (True, 155_189_248 + 83_886_080)])
def test_sealed_attention_bound_counts_the_valid_rows(verify, ops):
    """One granite layer at B 8, T 1024, K 8, G 4, hd 64: 131,072 K+V rows
    of 16 Threefry blocks (74 operations each) and, verifying, 32 MAC words
    (20 each); operations bound it."""
    b = chip_smoke.attention_bound(8, 8, 4, 64, 1024, verify)
    assert b["ops"] == ops
    assert b["bytes"] == (2 * 8 * 8 * 4 * 64 * 2 + 2 * 65536 * 128 + 256
                          + (2 * 65536 * 4 if verify else 0))
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] > b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    half = chip_smoke.attention_bound(8, 8, 4, 64, 512, verify)
    assert half["ops"] * 2 == ops


@pytest.mark.parametrize("M, K, N, bytes_ms, ops_ms", [
    (8192, 2048, 8192, 0.061, 0.058), (8192, 8192, 2048, 0.061, 0.144)])
def test_sealed_matmul_bound_is_set_by_the_tensor_cores(M, K, N, bytes_ms,
                                                        ops_ms):
    """Granite's MLP products of one 8192-token microbatch: 2MKN FLOP at
    989 TFLOP/s (0.278 ms) bound them, over the bytes of A, B, their tags
    and C and the integer work the inputs need (one Threefry block per
    four bf16, one MAC word per two); the kernel's keystream regeneration
    in 128 x 256 tiles shared by clusters of 4 x 2 is 18.5 MKN (2/512)
    operations."""
    b = chip_smoke.matmul_bound(M, K, N)
    elems = M * K + K * N
    assert b["ops"] == elems // 4 * 74 + elems // 2 * 20
    assert b["bytes"] == 2 * elems + 2 * M * N + elems // 64
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2 * M * K * N / 989e12 * 1e3)
    assert 0.277 < b["bound_ms"] < 0.279
    assert b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3 < bytes_ms
    assert b["ops"] / chip_smoke.INT32_OPS_PER_S * 1e3 < ops_ms
    assert b["keystream_ops"] == pytest.approx(18.5 * M * K * N * 2 / 512)


@pytest.mark.parametrize("verify", [False, True])
def test_bounds_count_alu_pipe_operations(verify):
    """The bounds count 42 of a Threefry block's 74 operations and 14 of a
    MAC word's 20 (those that must issue on the ALU pipe); bound_ms_74
    keeps all of them there."""
    rows = 2 * 8 * 1024 * 8
    b = chip_smoke.attention_bound(8, 8, 4, 64, 1024, verify)
    assert b["alu_ops"] == rows * 16 * 42 + (rows * 32 * 14 if verify else 0)
    assert b["bound_ms"] == pytest.approx(
        b["alu_ops"] / chip_smoke.INT32_OPS_PER_S * 1e3)
    assert b["bound_ms_74"] == pytest.approx(
        b["ops"] / chip_smoke.INT32_OPS_PER_S * 1e3)
    m = chip_smoke.matmul_bound(256, 256, 256, verify)
    elems = 2 * 256 * 256
    assert m["alu_ops"] == elems // 4 * 42 + (elems // 2 * 14 if verify else 0)


def _sass_line(addr, text):
    return (f"        /*{addr:04x}*/                   {text} ;"
            f"   /* 0x000fe20000000f00 */\n"
            "                                  /* 0x000fc80000000f00 */\n")


def test_mac_word_alu_ops_reads_the_lanes_four_words():
    """The ALU-pipe instructions (LOP3, SHF, LEA, IADD3, PRMT; predicated
    ones too, IMAD and VIADD not) between verify_chunks_kernel's last load
    and its first shuffle, per word."""
    body = ["LDG.E.128.CONSTANT R4, desc[UR6][R4.64]", "IMAD.X R9, RZ, RZ, R6",
            "LDG.E.128.CONSTANT R8, desc[UR6][R8.64]",
            "LOP3.LUT R17, R6, 0x7fffffff, RZ, 0xc0, !PT",
            "LEA.HI R14, R6, R17, RZ, 0x1", "VIADD R14, R14, 0x1",
            "IMAD.WIDE.U32 R4, R19, R10, RZ", "SHF.R.U64 R8, R4, 0x1f, R5",
            "@P0 IADD3 R10, P2, R4, R9, RZ", "PRMT R1, R2, 0x5410, R3",
            "LEA.HI.X R17, R17, RZ, RZ, 0x1, P2",
            "SHFL.DOWN R3, R8, 0x10, 0x1f",
            "LOP3.LUT R5, R8, 0x7fffffff, RZ, 0xc0, !PT"]
    text = "\t\tFunction : _Z11ctr_kernelv\n" + _sass_line(0, "LDG.E R1") \
        + "\t\tFunction : _ZN12_GLOBAL__N_120verify_chunks_kernelEPKt\n" \
        + "".join(_sass_line(16 * i, t) for i, t in enumerate(body))
    from repro_torch.kernels import build

    funcs = build.sass_opcodes(text)
    assert funcs["_Z11ctr_kernelv"] == ["LDG"]
    assert chip_smoke.mac_word_alu_ops(funcs) == 6 / 4


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("row_bytes, cw, path", [
    (98310, 2, "small"), (16, 4, "small"), (8192 * 2, 512, "wide"),
    (1024 * 2, 256, "wide"), (2560 * 2, 320, "general"),
    (92553 * 2, 77, "general"), (9728 * 2, 304, "general"),
    (1023 * 2, 256, "general"), (64 * 4, 64, "wide"), (24 * 4, 12, "general")])
def test_mac_path_follows_the_kernels_dispatch(row_bytes, cw, path):
    """cw <= 8 small; a power of two from 32 to 512 on rows of whole words
    wide; anything else (the families' cw 77-500, an odd-width row) the
    general path, as mac_tags_launch picks them."""
    assert chip_smoke.mac_path(row_bytes, cw) == path


def test_step_sums_count_each_leaf_of_a_case():
    """A decode step unseals every leaf once: a case shared by n leaves
    counts n times, and the general path's sums take only its cases."""
    cases = [dict(path="general", count=2, bytes=10, ctr_ms=1.0,
                  ctr_bound_ms=0.5, mac_ms=0.4, mac_bound_ms=0.2,
                  plain_ms=3.0),
             dict(path="wide", count=1, bytes=7, ctr_ms=2.0,
                  ctr_bound_ms=1.5, mac_ms=1.0, mac_bound_ms=0.9,
                  plain_ms=4.0)]
    s = chip_smoke.step_sums(cases)
    assert s["ctr_ms"] == 4.0 and s["ctr_bound_ms"] == 2.5
    assert s["mac_ms"] == pytest.approx(1.8)
    assert s["general_ms"] == pytest.approx(0.8)
    assert s["general_bound_ms"] == pytest.approx(0.4)
    assert s["general_bytes"] == 20 and s["bytes"] == 27
    assert s["plain_ms"] == 10.0


def test_families_phase_serves_moe_and_encdec_with_moonshot_cut_to_fit():
    """The families list names moonshot-v1-16b-a3b and
    seamless-m4t-large-v2; moonshot is cut to 24 of its 48 layers at full
    width, because a sealed decode step holds the tree's ciphertext and
    plaintext at once: 2 x 29.6 GB fits the 80 GB card, 2 x 58 GB would
    not."""
    from repro_torch import configs

    assert {"moonshot-v1-16b-a3b",
            "seamless-m4t-large-v2"} <= set(chip_smoke.FAMILY_ARCHS)
    assert chip_smoke.FAMILY_CUTS == {"moonshot-v1-16b-a3b": {"n_layers": 24}}
    cfg = configs.get_config("moonshot-v1-16b-a3b")
    assert cfg.n_layers == 48 and cfg.d_model == 2048

    def weight_bytes(n_layers):
        D, m = cfg.d_model, cfg.moe
        layer = (3 * m.n_experts * D * cfg.d_ff * 2        # experts
                 + 3 * D * m.d_ff_shared * 2               # shared expert
                 + D * m.n_experts * 4                     # f32 router
                 + 4 * D * cfg.n_heads * cfg.hd * 2 + 2 * D * 2)
        return n_layers * layer + 2 * cfg.vocab * D * 2 + D * 2

    assert 29.5e9 < weight_bytes(24) < 29.7e9
    assert 2 * weight_bytes(24) < 80e9 < 2 * weight_bytes(48)


def _train_params(cfg) -> int:
    """Parameters of a moe or encdec config, counted from its shapes."""
    D, V = cfg.d_model, cfg.vocab
    attn = 2 * D * cfg.n_heads * cfg.hd + 2 * D * cfg.n_kv_heads * cfg.hd
    if cfg.family == "moe":
        m = cfg.moe
        layer = (3 * m.n_experts * D * cfg.d_ff + 3 * D * m.d_ff_shared
                 + D * m.n_experts + attn + 2 * D)
        return cfg.n_layers * layer + 2 * V * D + D
    mlp = 3 * D * cfg.d_ff
    enc = attn + mlp + 2 * D
    dec = 2 * attn + mlp + 3 * D
    return (cfg.encdec.n_enc_layers * enc + cfg.encdec.n_dec_layers * dec
            + 2 * V * D + 2 * D)


def _meta_params(arch) -> int:
    """Parameters of a published config, from its init on the meta
    device."""
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = configs.get_config(arch)
    params = registry.get_model(cfg).init(torch.Generator(), cfg, "meta")
    return sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))


def test_train_families_phase_fits_moonshot_at_four_layers():
    """The train-families phase trains moonshot-v1-16b-a3b at full width
    cut to 4 of its 48 layers, seamless-m4t-large-v2, rwkv6-3b and
    zamba2-1.2b at full size, one 4096-token sequence a step: 10 bytes of
    sealed state a parameter (bf16 weights, f32 mu and nu) are 30.2 GB,
    20.3 GB, 31.0 GB and 11.8 GB; moonshot at 48 layers would be 160 GB,
    twice the card."""
    from repro_torch import configs

    assert chip_smoke.TRAIN_FAMILY_ARCHS == (
        "moonshot-v1-16b-a3b", "seamless-m4t-large-v2", "rwkv6-3b",
        "zamba2-1.2b")
    assert set(chip_smoke.LONG_PREFILL_ARCHS) <= set(
        chip_smoke.TRAIN_FAMILY_ARCHS)
    n_rwkv, n_zamba = _meta_params("rwkv6-3b"), _meta_params("zamba2-1.2b")
    assert 30.9e9 < 10 * n_rwkv < 31.1e9 and 11.7e9 < 10 * n_zamba < 11.9e9
    assert chip_smoke.TRAIN_FAMILY_CUTS == {
        "moonshot-v1-16b-a3b": {"n_layers": 4}}
    assert chip_smoke.CROSSPOD_ARCH in chip_smoke.TRAIN_FAMILY_ARCHS
    moon = configs.get_config("moonshot-v1-16b-a3b")
    n4 = _train_params(moon.with_(n_layers=4))
    assert 3.02e9 < n4 < 3.03e9 and 30.2e9 < 10 * n4 < 30.3e9
    assert 10 * _train_params(moon) > 2 * 80e9
    n_sm = _train_params(configs.get_config("seamless-m4t-large-v2"))
    assert 2.03e9 < n_sm < 2.04e9 and 20.3e9 < 10 * n_sm < 20.4e9
    for arch in chip_smoke.TRAIN_FAMILY_ARCHS:
        assert configs.opt_state_dtype(arch) == "float32"


@pytest.mark.parametrize("arch, want", [
    ("moonshot-v1-16b-a3b", {"n_layers": [48, 4], "global_batch": [256, 1],
                             "microbatch": [16, 1]}),
    ("seamless-m4t-large-v2", {"global_batch": [256, 1],
                               "microbatch": [16, 1]}),
    ("rwkv6-3b", {"global_batch": [256, 1], "microbatch": [16, 1]}),
    ("zamba2-1.2b", {"global_batch": [256, 1], "microbatch": [16, 1]})])
def test_train_family_reduced_lists_every_cut(arch, want):
    """The phase's ``reduced`` dict: [published, run] of the depth and of
    train_4k's global batch and microbatch (one sequence a step)."""
    assert chip_smoke.train_family_reduced(arch) == want


@pytest.mark.parametrize("shape, dtype, nbytes, blocks", [
    ((4, 300), torch.float32, 2 * 4 * 300 * 4, 4 * 150),
    ((3, 5), torch.int8, 2 * 15, 3 * 1), ((9,), torch.int8, 18, 2),
    ((2, 3, 7), torch.float32, 2 * 42 * 4, 6 * 4)])
def test_crosspod_payload_bound_counts_rows_of_words(shape, dtype, nbytes,
                                                     blocks):
    """One CTR pass over a payload reads and writes each byte once and
    takes one Threefry block per two words of a row (a row of bytes padded
    to whole words)."""
    b = chip_smoke.ctr_payload_bound(shape, dtype)
    assert b["bytes"] == nbytes
    assert b["alu_ops"] == blocks * chip_smoke.CTR_ALU_OPS_PER_BLOCK
    assert b["bound_by"] == "bytes"


def test_parallel_reduced_lists_every_cut():
    """EP: moonshot at 4 of 48 layers on one 2048-token sequence; the
    pipeline: granite on 4 microbatches of one 1024-token sequence."""
    assert chip_smoke.parallel_reduced() == {
        "ep": {"n_layers": [48, 4], "seq_len": [4096, 2048],
               "global_batch": [256, 1]},
        "pipeline": {"seq_len": [4096, 1024], "global_batch": [256, 4],
                     "microbatch": [16, 1]}}


def test_parallel_phase_lines_parse(capsys):
    """``print_parallel``: one line of gloo verdicts, one EP and one
    pipeline line a rank, the hop line, one restore line a rank and the
    phase's time; every number line carries the card."""
    import json
    import re

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    ep = dict(loss_global=12.5, loss_ep=12.5, loss_rel=0.0,
              loss_bits_equal=True, grad_rel_max=0.0,
              grad_worst_leaf="embed", grad_leaves_exact=30, grad_leaves=30,
              control_grad_rel_max=0.7, experts_held=32, wall_s_global=1.0,
              wall_s_ep=1.5, peak_bytes_global=2 ** 34,
              peak_bytes_ep=2 ** 33, held_bytes_global=2 ** 33,
              held_bytes_ep=2 ** 32)
    launches = {"ctr_cipher": 8, "tree_mac": 0, "sealed_attention": 0,
                "sealed_matmul": 0}
    ranks = [{"rank": r, "mesh_s": 7.0, "ep": ep,
              "pipeline": dict(stage=r, loss=11.0, loss_unpipelined=11.0,
                               loss_rel=0.0, loss_bits_equal=True,
                               grad_rel_max=0.0, grad_worst_leaf="embed",
                               grad_leaves_exact=12, grad_leaves=12,
                               control_grad_rel_max=float("inf"),
                               wall_s=2.0, wall_s_unpipelined=1.8,
                               launches=launches, peak_bytes=2 ** 34),
              "restore": dict(step=0, equal=True, wall_s=9.0,
                              bytes_held=2 ** 31, blocks_sharded=20,
                              leaves=12)} for r in range(2)]
    par = {"probe": {op: "ok" for op in chip_smoke.GLOO_PROBE_OPS},
           "hop": dict(ms=0.01, plain_ms=0.5, bound_ms=0.0026,
                       bound_by="bytes", bytes_per_tick=4194304),
           "ranks": ranks, "save_s": 5.0, "ckpt_bytes": 5 * 2 ** 30,
           "seconds": 120.0}
    chip_smoke.print_parallel(par, card)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 9 and all(ln.startswith("parallel") for ln in lines)
    assert all(ln.endswith(card) for ln in lines[:-1])
    probe = re.search(r"on the card (\{.*?\}); reduced", lines[0])
    assert json.loads(probe.group(1))["send_recv"] == "ok"
    hop = re.search(r"^parallel pipeline: (\d+) bytes a hop a tick; .* "
                    r"([\d.]+) ms in a CUDA graph against a ([\d.]+) ms "
                    r"bound \((\w+)\), plain version ([\d.]+) ms; "
                    r"fill-drain bubble .* = ([\d.]+);",
                    lines[5])
    assert hop.groups() == ("4194304", "0.0100", "0.0026", "bytes", "0.500",
                            "0.200")
    assert [ln.split(":")[0] for ln in lines[1:5]] == [
        "parallel ep rank 0", "parallel ep rank 1",
        "parallel pipeline stage 0", "parallel pipeline stage 1"]
    assert "32 experts held" in lines[1] and "bit for bit True" in lines[3]
    assert "every block equal bit for bit True" in lines[6]


@pytest.mark.parametrize("arch, want", [
    ("rwkv6-3b", {"wkv6_forward": 64, "wkv6_backward": 32}),
    ("zamba2-1.2b", {"ssd_forward": 74, "ssd_backward": 38}),
    ("granite-3-2b", {})])
def test_scan_launches_a_train_step(arch, want):
    """A forward per layer call and one more per remat recompute (every
    RWKV-6 block; 36 of zamba2's 38 layers, in full groups of 6), a
    backward per layer; no scan for a family without a recurrence."""
    from repro_torch.launch import steps
    cfg = steps.make_cell(arch, "train_4k", device="cpu").cfg
    assert chip_smoke.scan_launches_per_step(cfg) == want
    assert chip_smoke.scan_launches_per_step(cfg.with_(remat="none")) == {
        k: min(want.values()) for k in want}


def test_scan_bounds_count_bytes_and_flops_once():
    """One layer's scan over 4096 tokens: rwkv6-3b (40 heads of 64) and
    zamba2-1.2b (64 heads of p 64, N 64).  The bound counts each call's
    own inputs and outputs once and its FLOPs, and all four are bound by
    the float32 FLOPs; training's checkpoints (64 a head for both) come
    apart; the bound that counts them is the slower of bytes and FLOPs."""
    shapes = chip_smoke.scan_shapes()
    assert shapes == {"wkv6": (1, 4096, 40, 64), "ssd": (1, 4096, 64, 64,
                                                         64)}
    x, st, ck = 4096 * 40 * 64, 40 * 64 * 64, 64 * 40 * 64 * 64
    f = chip_smoke.scan_bound("wkv6", False, shapes["wkv6"])
    assert f["bytes"] == 4 * (5 * x + 40 * 64 + 2 * st)
    assert f["flops"] == 7 * 4096 * 40 * 64 * 64
    b = chip_smoke.scan_bound("wkv6", True, shapes["wkv6"])
    assert b["bytes"] == 4 * (9 * x + 40 * 64 + 2 * st + 40 * 64)
    assert b["flops"] == 2 * f["flops"]
    assert f["checkpoint_bytes"] == b["checkpoint_bytes"] == 4 * ck
    x, a, n = 4096 * 64 * 64, 4096 * 64, 4096 * 64
    s = chip_smoke.scan_bound("ssd", True, shapes["ssd"])
    assert s["bytes"] == 4 * (2 * a + 3 * x + 2 * 4096 * 64 + 2 * n * 64
                              + 2 * 64 * 64 * 64)
    assert s["flops"] == 14 * 4096 * 64 * 64 * 64
    assert s["checkpoint_bytes"] == 4 * 64 * 64 * 64 * 64
    ssd = (s, chip_smoke.scan_bound("ssd", False, shapes["ssd"]))
    for r in (f, b, *ssd):
        ops_ms = r["flops"] / chip_smoke.F32_FLOPS_PER_S * 1e3
        bytes_ms = ((r["bytes"] + r["checkpoint_bytes"])
                    / chip_smoke.HBM_BYTES_PER_S * 1e3)
        assert r["bound_by"] == "operations"
        assert r["bound_ms"] == pytest.approx(ops_ms)
        assert r["bound_with_checkpoints_ms"] == pytest.approx(
            max(bytes_ms, ops_ms))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_long_prefill_cuts_only_the_batch(arch):
    """prefill_32k's 32 prompts of 32768 tokens cut to one, at full
    length; its logits checked against the plain loops at 2048."""
    assert chip_smoke.long_prefill_reduced(arch) == {
        "global_batch": [32, 1], "seq_len": [32768, 32768]}
    assert chip_smoke.LONG_PREFILL_CHECK == 2048
    assert arch in chip_smoke.LONG_PREFILL_ARCHS


def test_plain_scans_swap_the_models_scans_back():
    """Inside ``plain_scans`` the models' scans are the plain loops; after
    it, the ops' own (which launch the kernels on the card)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wkv6_scan import ops as wkv_ops
    before = wkv_ops.wkv6_scan, ssd_ops.ssd_scan
    with chip_smoke.plain_scans():
        assert wkv_ops.wkv6_scan is not before[0]
        r = torch.ones((1, 3, 1, 2))
        y, s = wkv_ops.wkv6_scan(r, r, r, r, torch.ones((1, 2)),
                                 torch.zeros((1, 1, 2, 2)))
        assert tuple(y.shape) == (1, 3, 1, 2) and tuple(s.shape) == (1, 1,
                                                                     2, 2)
    assert (wkv_ops.wkv6_scan, ssd_ops.ssd_scan) == before


def test_scan_and_long_prefill_lines_parse(capsys):
    """``print_scan_checks`` and ``print_long_prefill``: every line names
    the card."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    chip_smoke.print_scan_checks([
        {"name": "wkv6_forward", "shape": (1, 4096, 40, 64),
         "max_abs_err": 1e-6, "tolerance": {"rtol": 1e-5}, "ms": 0.9,
         "ms_with_checkpoints": 1.0, "plain_ms": 100.0, "bound_ms": 0.07,
         "bound_by": "operations", "bytes": 1, "flops": 2,
         "checkpoint_bytes": 3, "bound_with_checkpoints_ms": 0.16}], card)
    n, m = chip_smoke.LONG_PREFILL_LEN, chip_smoke.LONG_PREFILL_CHECK
    run = {"wall_s": 2.0, "launches": {"wkv6_forward": 32},
           "peak_bytes": 2**30}
    logits = {dt: {"diff": 0.01, "limit": 0.5, "plain_wall_s": 3.0}
              for dt in ("bfloat16", "float32")}
    chip_smoke.print_long_prefill({"arch": "rwkv6-3b", "setup_s": 1.0,
                                   "reduced": {}, n: run, m: run,
                                   "logits": logits}, card)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.endswith(card) for ln in lines)
    assert "with checkpoints 1.0000 ms: + 3 checkpoint bytes" in lines[0]
    assert "16384 tok/s" in lines[1]
    assert "bfloat16 0.01 (limit 0.5; plain loops 3.000 s); float32 0.01" \
        in lines[2]


def test_ssd_plan_line_names_kernels_grids_and_the_card(capsys):
    """An SSD check prints a second line: the kernels of a call and their
    grids (the launcher's report, ``last_plan``), the time against the
    bound, the repeat and the decays of 0 and 1."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    plan = {"kernels_per_call": 3, "heads_per_block": 8, "threads": 256,
            "grids": {"ssd_local_kernel<true>": [64, 8, 1],
                      "ssd_carry_kernel<true>": [1024, 1, 1],
                      "ssd_grad_kernel": [64, 8, 1]}}
    chip_smoke.print_scan_checks([
        {"name": "ssd_backward", "shape": (1, 4096, 64, 64, 64),
         "max_abs_err": 1e-4, "tolerance": {"rtol": 1e-4}, "ms": 0.8,
         "plain_ms": 1000.0, "bound_ms": 0.2, "bound_by": "operations",
         "bytes": 1, "flops": 2, "checkpoint_bytes": 3,
         "bound_with_checkpoints_ms": 0.2, "repeat_bitwise": True,
         "zero_decay_err": 1e-3,
         "kernel_ms": {"ssd_grad_kernel": 0.6, "ssd_local_kernel<true>": 0.1,
                       "ssd_carry_kernel<true>": 0.05}, "plan": plan}],
        card)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(ln.endswith(card) for ln in lines)
    assert lines[1].startswith("ssd plan ssd_backward: ")
    assert '"ssd_grad_kernel": [64, 8, 1]' in lines[1]
    assert "(25.0%); two runs bit for bit True" in lines[1]


def test_launch_counts_cover_every_kernel_wrapper():
    """``zero_launches`` / ``read_launches`` reach every wrapper of the
    port's kernels that counts its launches, so each phase reads them
    all."""
    import importlib
    import pkgutil

    from repro_torch import kernels

    counted = {id(fn) for fn in chip_smoke._counted().values()}
    wrappers = {}
    for mod in pkgutil.iter_modules(kernels.__path__):
        if not mod.ispkg:
            continue
        ops = importlib.import_module(f"repro_torch.kernels.{mod.name}.ops")
        for name, fn in vars(ops).items():
            if callable(fn) and hasattr(fn, "launches") \
                    and getattr(fn, "__module__", None) == ops.__name__:
                wrappers[f"{mod.name}.{name}"] = fn
    assert {"flash_attention.flash_forward",
            "flash_attention.flash_backward"} <= set(wrappers)
    missing = [n for n, fn in wrappers.items() if id(fn) not in counted]
    assert not missing, missing


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flash_bound_counts_the_causal_pairs(kind):
    """The kernel table's bound counts what the fused ops' FLOP formulas
    count: 4 hd FLOPs a visible pair forward, 8 backward."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, S, T, K, G, hd = chip_smoke.FLASH_SHAPES[kind]
    if kind == "train":
        bases, at_end = [0] * B, False
    else:
        bases, at_end = [T - S] * B, True
    for backward, flops in ((False, fa_ops.forward_flops),
                            (True, fa_ops.backward_flops)):
        got = chip_smoke.flash_bound(B, S, T, K, G, hd, bases, backward)
        assert got["flops"] == flops(B, S, T, K * G, hd, at_end)
        assert got["bound_ms"] == pytest.approx(
            got["flops"] / chip_smoke.BF16_FLOPS_PER_S * 1e3)
