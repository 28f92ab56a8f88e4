"""The traffic generator, the end-to-end arithmetic and the frozen
formulas of work."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.core import stats, traffic, work
from bench.drivers.serve_closed_loop import Recorder, Tick, end_to_end

ROOT = Path(__file__).resolve().parents[2]
CHAT = json.loads((ROOT / "bench" / "traffic" / "chat.json").read_text())
TRAIN = json.loads((ROOT / "bench" / "traffic" / "train-4k.json").read_text())
SEEDS = (2 ** 31 + 11, 3_000_000_019)


def test_same_seed_same_requests_other_seed_other_tokens():
    a = traffic.serve_requests(CHAT, 100352, SEEDS[0])
    b = traffic.serve_requests(CHAT, 100352, SEEDS[0])
    c = traffic.serve_requests(CHAT, 100352, SEEDS[1])
    assert all((p == q).all() and o == r for (p, o), (q, r) in zip(a, b))
    assert not all((p[:8] == q[:8]).all() for (p, _), (q, _) in zip(a, c))
    # every seed serves the same schedule of sizes
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in c]


def test_every_block_holds_the_same_lengths():
    """Each block of requests after the warm start holds the same
    (prompt, output) pairs, in an order of its own."""
    B, c = CHAT["block"], CHAT["clients"]
    want = sorted(zip(*traffic.block_pairs(CHAT)))
    for seed in SEEDS:
        reqs = traffic.serve_requests(CHAT, 100352, seed)
        orders = set()
        for k in range(-(-c // B), CHAT["n_requests"] // B):
            blk = reqs[k * B:(k + 1) * B]
            assert sorted((len(p), o) for p, o in blk) == want
            orders.add(tuple(len(p) for p, _ in blk))
        assert len(orders) > 1
        # the warm start keeps only a residual of the first outputs
        first = [o for _, o in reqs[:c]]
        assert all(2 <= o <= CHAT["output_len"]["max"] for o in first)


@pytest.mark.parametrize("key", ["prompt_len", "output_len"])
def test_lengths_keep_their_clips_and_median(key):
    spec = CHAT[key]
    q = traffic.quantiles(spec, CHAT["block"])
    assert q.min() >= spec["min"] and q.max() <= spec["max"]
    assert abs(np.median(q) - spec["median"]) <= 0.05 * spec["median"]


def test_token_ids_uniform_over_the_vocabulary():
    ids = np.concatenate([p for p, _ in traffic.serve_requests(
        CHAT, 1000, SEEDS[0])])
    assert ids.min() >= 0 and ids.max() < 1000
    counts = np.bincount(ids, minlength=1000)
    assert counts.std() / counts.mean() < 0.1


def test_train_batches_from_the_seed():
    import torch
    t = dict(TRAIN, seq_len=64)
    a = traffic.train_tokens(t, 512, SEEDS[0], 1, "cpu")
    assert a.shape == (t["batch"], 65)
    assert torch.equal(a, traffic.train_tokens(t, 512, SEEDS[0], 1, "cpu"))
    assert not torch.equal(a, traffic.train_tokens(t, 512, SEEDS[0], 2,
                                                   "cpu"))
    assert not torch.equal(a[0], a[1])


def _recorder(durs, n_dec, admitted):
    rec = Recorder.__new__(Recorder)
    t, ticks = 100.0, []
    for d, n, a in zip(durs, n_dec, admitted):
        t += d
        ticks.append(Tick(t, d, n, a, 0))
    rec.ticks, rec.first_window_tick = ticks, 1
    rec.t0, rec.t1 = ticks[0].t_end, ticks[-1].t_end
    return rec


def test_end_to_end_over_every_sample():
    """Rates over the whole window, tails over every token and request of
    it (the ramp's last tick before the window left out)."""
    durs = [0.5] + [0.03] * 8 + [0.09, 0.12]
    n_dec = [4] * 11
    admitted = [[0, 1, 2, 3]] + [[]] * 8 + [[4], [5, 6]]
    e = end_to_end(_recorder(durs, n_dec, admitted))
    secs = sum(durs[1:])
    assert e["serve_out_tok_s"] == pytest.approx((4 * 10 + 3) / secs)
    assert e["ttft_p95_ms"] == pytest.approx(1e3 * np.percentile(
        [0.09, 0.12, 0.12], 95))
    gaps = [0.03] * 32 + [0.09] * 3 + [0.12] * 2
    assert e["tpot_p95_ms"] == pytest.approx(1e3 * np.percentile(gaps, 95))


def test_rates_and_shares():
    assert stats.share(1.0, 4.0) == 25.0
    assert stats.rate(10, 4.0) == 2.5
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


TINY = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
        "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 32}


def test_flops_by_hand():
    m = TINY
    # attention 8*2*4*2 (q, o) + 2*8*1*4 (k, v) = 128 + 64; mlp 3*8*16
    layer = 128 + 64 + 384
    assert work.layer_params(m, True) == layer
    n = 2 * layer + 8 * 32
    assert work.matmul_params(m) == n
    entry = 2 * (4 + 4) * 2
    assert work.attn_entry_flops(m) == entry
    assert work.decode_token_flops(m, 10) == 2 * n + 2 * entry * 10
    assert work.prefill_flops(m, 3) == 2 * n * 3 + 2 * entry * 6
    assert work.train_step_flops(m, 2, 3) == 6 * n * 6 + 3 * 2 * 2 * entry * 6


def test_moe_active_parameters_by_hand():
    m = dict(TINY, family="moe", n_experts=4, experts_per_token=2)
    assert work.layer_params(m, True) == 192 + 2 * 384 + 8 * 4
    assert work.layer_params(m, False) == 192 + 4 * 384 + 8 * 4


def test_attention_need_by_hand():
    flops, byts = work.prefill_attention_need(TINY, 4, 2)
    assert flops == 2 * (2 * 8 * 2) * 10
    # q and o: 4 rows x 2 heads x 4; k and v: 4 rows x 1 head x 4; 2 bytes
    assert byts == 2 * 2 * 4 * (2 * 2 * 4 + 2 * 1 * 4)
    assert work.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def _reader(name):
    from bench.core import harness
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                               "reader_" + name.replace(".", "_")).read


def test_serving_readers_over_every_tick():
    m = dict(TINY, family="dense")
    ticks = [Tick(1.0, 0.03, 4, [], 40), Tick(1.1, 0.1, 3, [0], 33),
             Tick(1.13, 0.03, 4, [], 44)]
    r = {"kind": "serve", "model": m, "clients": 4, "ticks": ticks,
         "lens": [5], "traced_prompts": [5, 7],
         "trace": {"window_s": 2.0, "busy_s": 1.5,
                   "device_by_name": {"flash_fwd_sm90_kernel<x>": 1e-6,
                                      "gemm": 9.0},
                   "range_device_s": {"bench.prefill": 0.024}}}
    assert _reader("slot_occupancy.serve")(r) == pytest.approx(
        100 * 11 / 12)
    assert _reader("decode_step_ms.serve")(r) == pytest.approx(30.0)
    flops = (11 * 2.0 * work.matmul_params(m)
             + 2 * work.attn_entry_flops(m) * 117 + work.prefill_flops(m, 5))
    assert _reader("mfu.serve")(r) == pytest.approx(
        100 * flops / 0.16 / 989e12)
    assert _reader("prefill_ms_per_ktok.serve")(r) == pytest.approx(
        0.024 * 1e6 / 12)
    assert _reader("idle_share.serve")(r) == pytest.approx(25.0)
    need = sum(work.least_seconds(*work.prefill_attention_need(m, n, 2))
               for n in (5, 7))
    assert _reader("flash_roofline.serve")(r) == pytest.approx(
        100 * need / 1e-6)
    # a reader that finds nothing to read returns nothing, never 0
    assert _reader("flash_roofline.serve")(dict(r, trace=None)) is None
    assert _reader("mfu.train")(r) is None


def test_training_readers():
    r = {"kind": "train", "model": TINY, "traffic": {"batch": 2,
                                                     "seq_len": 3},
         "steps": 4, "seconds": 2.0, "window_peak_bytes": 48e9,
         "trace": {"window_s": 1.0, "busy_s": 0.97}}
    assert _reader("mfu.train")(r) == pytest.approx(
        100 * 4 * work.train_step_flops(TINY, 2, 3) / 2.0 / 989e12)
    assert _reader("idle_share.train")(r) == pytest.approx(3.0)
    assert _reader("hbm_peak_gb.train")(r) == pytest.approx(48.0)
