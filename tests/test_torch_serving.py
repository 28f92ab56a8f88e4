"""repro_torch's serving path on the CPU against the reference package: the
engines' greedy tokens, the scheduler, the per-phase roofline profiles, the
power policies, EnergySession and its telemetry, and the serve CLI.

Both packages serve the reduced qwen2.5-14b config in f32 on the same
parameters (the reference's ``init_params`` tree with random biases,
handed over through :func:`repro_torch.convert.params_from_jax`); the
generate, serve() and CLI cases also serve the reduced dbrx-132b (MoE) and
deepseek-v3-671b (MoE with MLA attention), whose norm gains are drawn at
random as well, on the MoE local path; the generate and CLI cases also
the reduced mamba2-2.7b (SSM) and recurrentgemma-2b (hybrid RG-LRU), on
the lock-step route, with every leaf the reference sets to zeros or ones
drawn at random. Greedy tokens must be equal, for the same admission
order: the logits agree to about 1e-6 (tests/test_torch_models.py), far
inside the top-2 margins of these prompts. Profiles, decisions and
session summaries are float64 host arithmetic in both packages: values
are held to rtol 1e-12 (``torch.pow`` against numpy's pow) and every
discrete decision — frequency, mode, step count — to equality."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st
from torch_recurrent_params import redraw

import repro.power as ref_power
import repro.serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.core import governor as ref_governor
from repro.core import telemetry as ref_telemetry
from repro.core.hardware import CHIPS as REF_CHIPS
from repro.models import model as ref_model
from repro.models.transformer import Runtime as RefRuntime
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import governor, telemetry
from repro_torch.core.hardware import CHIPS, H100_SXM
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import Runtime
from repro_torch.power import (EnergySession, ProfileArray, decide_batch,
                               get_policy)
from repro_torch.serving import (ContinuousEngine, Request, ServeEngine,
                                 poisson_arrivals, scale_profile, serve,
                                 serving_profiles)

RTOL = 1e-12
MAX_LEN = 48
#: the MoE configs served besides qwen2.5-14b: GQA, and MLA attention
MOE_ARCHS = ["dbrx-132b", "deepseek-v3-671b"]
#: norm gains (initialised to ones), drawn at random in the MoE models
GAINS = ("ln1", "ln2", "q_norm", "kv_norm")


def _served(arch):
    """(reference cfg, params; port cfg, params) of ``arch`` reduced, in
    f32, on the reference's parameters with random biases and gains."""
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    rng = np.random.default_rng(3)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = 0.1 * rng.standard_normal(
                attn[name].shape).astype(np.float32)
    if cfg.family == "moe":
        for sub in (tree["layers"], attn):
            for name in GAINS:
                if name in sub:
                    sub[name] = 1.0 + 0.1 * rng.standard_normal(
                        sub[name].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    params = convert.params_from_jax(tree, cfg, device="cpu")
    return rcfg, rparams, cfg, params


@pytest.fixture(scope="module")
def served():
    return _served("qwen2.5-14b")


@pytest.fixture(scope="module", params=MOE_ARCHS)
def served_moe(request):
    return _served(request.param)


def _requests(cfg, lengths, budgets, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, int(l), dtype=np.int32),
                    max_new_tokens=int(m)) for l, m in zip(lengths, budgets)]


def _ref_requests(reqs):
    return [ref_serving.Request(r.prompt, r.max_new_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", [(9, 9, 9), (5, 12, 9)])
def test_generate_both_routes_match_the_reference(served, lengths):
    _check_generate(served, lengths)


@pytest.mark.parametrize("lengths", [(9, 9, 9), (5, 12, 9)])
def test_moe_generate_both_routes_match_the_reference(served_moe, lengths):
    """dbrx-132b and deepseek-v3-671b: the continuous route (per-slot
    caches, latent for MLA) and the lock-step route give the reference's
    greedy tokens."""
    _check_generate(served_moe, lengths)


#: the recurrent configs: SSM and hybrid RG-LRU, served on the lock-step
#: route
REC_ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]


@pytest.fixture(scope="module", params=REC_ARCHS)
def served_rec(request):
    """A recurrent config reduced, in f32, on the reference's parameters
    with the leaves of ``torch_recurrent_params.REC_AROUND`` drawn at
    random."""
    arch = request.param
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rparams, _ = ref_model.init_params(rcfg, RefRuntime(tp=1),
                                       jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    redraw(tree, np.random.default_rng(3))
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            convert.params_from_jax(tree, cfg, device="cpu"))


@pytest.mark.parametrize("lengths", [(9, 9, 9), (5, 12, 9)])
def test_recurrent_generate_matches_the_reference(served_rec, lengths,
                                                  monkeypatch):
    """mamba2-2.7b and recurrentgemma-2b: greedy generate takes the
    lock-step route (a recurrent state has no position-indexed rows to fill
    a slot from) and gives the reference's tokens; ragged prompts are
    right-padded and the pads folded into the state, in both packages."""
    def no_slot_pool(*args, **kw):
        raise AssertionError("the continuous route took a recurrent model")
    monkeypatch.setattr(ServeEngine, "_generate_continuous", no_slot_pool)
    _check_generate(served_rec, lengths)


def _check_generate(served, lengths):
    rcfg, rparams, cfg, params = served
    reqs = _requests(cfg, lengths, (6, 6, 6), seed=len(set(lengths)))
    reng = ref_serving.ServeEngine(rcfg, RefRuntime(tp=1), rparams,
                                   max_len=MAX_LEN)
    eng = ServeEngine(cfg, Runtime(), params, max_len=MAX_LEN)
    want_cont = reng.generate(_ref_requests(reqs))
    want_lock = reng.generate_blocking(_ref_requests(reqs))
    got_cont = eng.generate(reqs)
    got_lock = eng.generate_blocking(reqs)
    for g, w in zip(got_cont, want_cont):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_lock, want_lock):
        np.testing.assert_array_equal(g, w)
    # same length: the routes of a dense model agree too. An MoE layer's
    # capacity drops depend on every token of its batch (pads included), so
    # a prompt prefilled alone and the same prompt in a batch of three may
    # route differently, in the reference as in the port
    if len(set(lengths)) == 1 and cfg.family == "dense":
        for c, l in zip(got_cont, got_lock):
            np.testing.assert_array_equal(c, l)


def test_serve_matches_the_reference(served):
    """The same arrivals through a 3-slot pool: equal tokens per request,
    equal scheduling (steps, prefills, occupancy, queue), and the port's
    per-slot masking keeps a request's tokens independent of its
    batch-mates, as in the reference."""
    _check_serve(served)


def test_moe_serve_matches_the_reference(served_moe):
    """serve() of dbrx-132b and deepseek-v3-671b, as for qwen2.5-14b."""
    _check_serve(served_moe)


def _check_serve(served):
    rcfg, rparams, cfg, params = served
    rng = np.random.default_rng(2)
    reqs = _requests(cfg, rng.integers(2, 14, 8), rng.integers(1, 7, 8),
                     seed=5)
    arrivals = poisson_arrivals(8, 1.0, seed=4)
    np.testing.assert_array_equal(
        arrivals, ref_serving.poisson_arrivals(8, 1.0, seed=4))
    reng = ref_serving.ContinuousEngine(rcfg, RefRuntime(tp=1), rparams,
                                        max_slots=3, max_len=MAX_LEN)
    want = ref_serving.serve(reng, _ref_requests(reqs), arrivals=arrivals)
    eng = ContinuousEngine(cfg, Runtime(), params, max_slots=3,
                           max_len=MAX_LEN)
    got = serve(eng, reqs, arrivals=arrivals)
    for g, w in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(g, w)
    assert (got.n_steps, got.n_prefills, got.tokens_out, got.queue_peak) \
        == (want.n_steps, want.n_prefills, want.tokens_out, want.queue_peak)
    assert got.occupancy_mean == want.occupancy_mean
    solo = ContinuousEngine(cfg, Runtime(), params, max_slots=1,
                            max_len=MAX_LEN)
    for i in (0, 5):
        np.testing.assert_array_equal(serve(solo, [reqs[i]]).outputs[0],
                                      got.outputs[i])


def test_engine_session_matches_the_reference(served):
    """A served trace metered by an energy-aware session: the decisions
    depend only on the profiles and the tick structure, so everything but
    the measured wall time equals the reference's."""
    rcfg, rparams, cfg, params = served
    pre, dec = serving_profiles(get_config("qwen2.5-14b"), batch=4,
                                prompt_len=512, context_len=2048)
    rpre, rdec = ref_serving.serving_profiles(
        ref_get_config("qwen2.5-14b"), chip=REF_CHIPS["h100-sxm"], batch=4,
        prompt_len=512, context_len=2048)
    sess = EnergySession(policy="energy-aware", device="cpu")
    rsess = ref_power.EnergySession(policy="energy-aware",
                                    chip=REF_CHIPS["h100-sxm"])
    reqs = _requests(cfg, (5, 5, 8, 3, 6, 5), (4,) * 6, seed=8)
    arrivals = poisson_arrivals(6, 2.0, seed=0)
    eng = ContinuousEngine(cfg, Runtime(), params, max_slots=4,
                           max_len=MAX_LEN, session=sess,
                           prefill_profile=pre, decode_profile=dec)
    reng = ref_serving.ContinuousEngine(rcfg, RefRuntime(tp=1), rparams,
                                        max_slots=4, max_len=MAX_LEN,
                                        session=rsess,
                                        prefill_profile=rpre,
                                        decode_profile=rdec)
    serve(eng, reqs, arrivals=arrivals)
    ref_serving.serve(reng, _ref_requests(reqs), arrivals=arrivals)
    got, want = sess.summary(), rsess.summary()
    got.pop("wall_s"), want.pop("wall_s")
    _close_dicts(got, want)
    _close_dicts(sess.phase_report(), rsess.phase_report())
    freqs = sorted(r["freq_mhz_mean"] for r in sess.phase_report().values())
    assert freqs[0] < H100_SXM.f_nominal_mhz == freqs[1]
    assert sess.actuator.history == rsess.actuator.history


def _close_dicts(got, want):
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _close_dicts(g, w)
        elif isinstance(w, str):
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_continuous_engine_rejects_other_families():
    """The slot pool serves the dense and MoE families only: a recurrent
    state has no position-indexed rows, and the pool holds no memory for
    the VLM's or enc-dec's cross-attention (as in the reference)."""
    for arch in ("mamba2-2.7b", "recurrentgemma-2b", "llama-3.2-vision-11b",
                 "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        with pytest.raises(ValueError, match="continuous batching"):
            ContinuousEngine(cfg, None, None)


def test_sampling_route_runs_and_stays_in_the_vocab(served):
    _, _, cfg, params = served
    eng = ServeEngine(cfg, Runtime(), params, max_len=MAX_LEN)
    outs = eng.generate(_requests(cfg, (4, 7), (5, 5)), temperature=0.8,
                        seed=3)
    again = eng.generate(_requests(cfg, (4, 7), (5, 5)), temperature=0.8,
                         seed=3)
    for o, a in zip(outs, again):
        assert o.shape == (5,) and 0 <= o.min() and o.max() < cfg.vocab_size
        np.testing.assert_array_equal(o, a)        # seeded


def test_no_kernel_launch_on_cpu_tensors(served):
    _, _, cfg, params = served
    ops.reset_launch_counts()
    ServeEngine(cfg, Runtime(), params, max_len=MAX_LEN).generate(
        _requests(cfg, (6,), (2,)))
    assert ops.launch_counts()["flash_attention"] == 0


def test_serve_cli_runs_on_the_cpu(capsys):
    _check_cli(capsys, [])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_the_moe_configs_on_the_cpu(capsys, arch):
    _check_cli(capsys, ["--arch", arch])


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_serve_cli_runs_the_recurrent_configs_on_the_cpu(capsys, arch):
    _check_cli(capsys, ["--arch", arch])


def _check_cli(capsys, extra):
    out = serve_cli.main(["--reduced", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "6", "--new-tokens", "3",
                          "--max-len", "32", "--policy", "energy-aware",
                          *extra])
    assert len(out["outputs"]) == 2
    assert all(o.shape == (3,) for o in out["outputs"])
    assert out["summary"]["policy"] == "energy-aware"
    assert out["summary"]["steps"] == 3
    assert "savings" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# profiles, policies, session, telemetry (no model)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "stablelm-12b",
                                  "dbrx-132b", "mamba2-2.7b"])
@pytest.mark.parametrize("chip", ["h100-sxm", "tpu-v5e", "mi250x-gcd"])
def test_serving_profiles_match(arch, chip):
    for kw in (dict(), dict(batch=2, prompt_len=100, context_len=300,
                            chips=4)):
        got = serving_profiles(get_config(arch), chip=CHIPS[chip], **kw)
        want = ref_serving.serving_profiles(ref_get_config(arch),
                                            chip=REF_CHIPS[chip], **kw)
        for g, w in zip(got, want):
            assert (g.compute_s, g.memory_s, g.collective_s) == \
                (w.compute_s, w.memory_s, w.collective_s)
    pre, dec = serving_profiles(get_config(arch), chip=CHIPS[chip])
    if arch != "mamba2-2.7b":
        assert pre.compute_s > pre.memory_s and dec.memory_s > dec.compute_s


def test_scale_profile_keeps_intensity():
    p = StepProfile(compute_s=0.2, memory_s=1.0)
    s = scale_profile(p, 0.005)
    assert s.total_s == pytest.approx(0.005)
    assert s.compute_s / s.memory_s == pytest.approx(0.2)


def _profiles(n, seed):
    rng = np.random.default_rng(seed)
    return [StepProfile(float(c), float(m), float(x)) for c, m, x in
            rng.exponential(1.0, (n, 3)) * np.array([1.0, 1.0, 0.2])]


POLICY_SPECS = [("nominal", {}), ("static", dict(freq_mhz=900)),
                ("power-cap", dict(cap_w=350.0)),
                ("energy-aware", {}),
                ("energy-aware", dict(slowdown_budget=0.1, cap_w=500.0)),
                ("energy-aware", dict(objective="edp"))]


def _same_decision(g, w):
    assert g.freq_mhz == w.freq_mhz and g.mode.idx == w.mode.idx
    np.testing.assert_allclose(
        [g.freq_frac, g.time_s, g.power_w, g.energy_j, g.baseline_energy_j],
        [w.freq_frac, w.time_s, w.power_w, w.energy_j, w.baseline_energy_j],
        rtol=RTOL, atol=0)


@pytest.mark.parametrize("name,knobs", POLICY_SPECS)
@pytest.mark.parametrize("chip", ["h100-sxm", "mi250x-gcd"])
def test_policy_decisions_match(name, knobs, chip):
    pol = get_policy(name, **knobs)
    rpol = ref_power.get_policy(name, **knobs)
    model = ChipModel(chip)
    rmodel = ref_power.ChipModel(chip)
    profs = _profiles(12, seed=len(name))
    rprofs = [ref_power.StepProfile(p.compute_s, p.memory_s, p.collective_s)
              for p in profs]
    for p, rp in zip(profs, rprofs):
        _same_decision(pol.decide(p, model), rpol.decide(rp, rmodel))
    got = decide_batch(pol, profs, model, device="cpu").decisions()
    want = ref_power.policies.decide_batch(rpol, rprofs, rmodel).decisions()
    for g, w in zip(got, want):
        _same_decision(g, w)


def test_get_policy_resolution():
    assert get_policy(None).name == "nominal"
    pol = get_policy("energy-aware")
    assert get_policy(pol) is pol
    with pytest.raises(KeyError, match="unknown power policy"):
        get_policy("turbo")
    with pytest.raises(ValueError, match="freq_mhz"):
        get_policy("static")
    with pytest.raises(ValueError, match="cap_w"):
        get_policy("power-cap")
    with pytest.raises(TypeError):
        get_policy(3)


class _ThirdParty:
    """A policy with only ``decide``: decide_batch lifts its loop."""
    name = "third-party"

    def decide(self, profile, chip):
        return get_policy("static", freq_mhz=1200).decide(profile, chip)


@pytest.mark.parametrize("name,knobs", POLICY_SPECS + [("third", {})])
def test_session_summary_matches(name, knobs):
    pol = _ThirdParty() if name == "third" else get_policy(name, **knobs)
    rpol = (ref_power.get_policy("static", freq_mhz=1200) if name == "third"
            else ref_power.get_policy(name, **knobs))
    sess = EnergySession(policy=pol, device="cpu", window_s=2.0)
    rsess = ref_power.EnergySession(policy=rpol, chip=REF_CHIPS["h100-sxm"],
                                    window_s=2.0)
    profs = _profiles(9, seed=11)
    rprofs = [ref_power.StepProfile(p.compute_s, p.memory_s, p.collective_s)
              for p in profs]
    for i, (p, rp) in enumerate(zip(profs[:3], rprofs[:3])):
        sess.observe(i, p, wall_s=0.01)
        rsess.observe(i, rp, wall_s=0.01)
    sess.observe_many(profs[3:6], wall_s=[0.1, 0.2, 0.3])
    rsess.observe_many(rprofs[3:6], wall_s=[0.1, 0.2, 0.3])
    pa = ProfileArray.from_profiles(profs[6:], device="cpu")
    sess.observe_many(pa, wall_s=0.5)
    rsess.observe_many(ref_power.ProfileArray.from_profiles(rprofs[6:]),
                       wall_s=0.5)
    got, want = sess.summary(), rsess.summary()
    if name == "third":
        got.pop("policy"), want.pop("policy")
    _close_dicts(got, want)
    _close_dicts(sess.phase_report(), rsess.phase_report())
    assert sess.actuator.history == rsess.actuator.history
    assert len(sess.telemetry.windows) == len(rsess.telemetry.windows)
    for g, w in zip(sess.telemetry.windows, rsess.telemetry.windows):
        assert (g.samples, g.mode_hist, g.job_id) == \
            (w.samples, w.mode_hist, w.job_id)
        np.testing.assert_allclose(
            [g.t_start, g.t_end, g.mean_power_w, g.energy_j],
            [w.t_start, w.t_end, w.mean_power_w, w.energy_j], rtol=RTOL)
    with pytest.raises(ValueError, match="wall_s has"):
        sess.observe_many(profs[:2], wall_s=[0.1])


def test_telemetry_store_matches_the_reference():
    rng = np.random.default_rng(4)
    store, rstore = telemetry.TelemetryStore(5.0), \
        ref_telemetry.TelemetryStore(5.0)
    t = 0.0
    for i in range(40):
        d = float(rng.exponential(1.0))
        kw = dict(step=i, t=t, duration_s=d, power_w=float(rng.uniform(
            90, 700)), energy_j=float(rng.uniform(1, 50)),
            mode=int(rng.integers(1, 5)), freq_mhz=1980,
            job_id="a" if i < 25 else "b")
        store.record(telemetry.StepSample(**kw))
        rstore.record(ref_telemetry.StepSample(**kw))
        t += d
    assert store.to_json() == rstore.to_json()
    np.testing.assert_array_equal(store.powers(), rstore.powers())
    assert store.job_ids() == rstore.job_ids() == ["a", "b"]
    assert store.mode_hours_pct() == rstore.mode_hours_pct()
    assert store.total_energy_j() == rstore.total_energy_j()
    back = telemetry.TelemetryStore.from_json(store.to_json(), 5.0)
    assert back.to_json() == store.to_json()


def test_simulated_actuator_matches_the_reference():
    act = governor.SimulatedActuator(H100_SXM)
    ract = ref_governor.SimulatedActuator(REF_CHIPS["h100-sxm"])
    assert act.current_mhz() == ract.current_mhz() == 1980
    for f in (900, 1200.0, 210):
        act.apply(f)
        ract.apply(f)
    assert act.history == ract.history and act.current_mhz() == 210


# ---------------------------------------------------------------------------
# the scheduler with a fake engine (no model)
# ---------------------------------------------------------------------------
class _FakePrefix:
    def __init__(self, rid, token, length, max_new, temperature):
        self.state, self.token, self.length = rid, token, length
        self.max_new, self.temperature = max_new, temperature


class _FakeEngine:
    """The slot protocol serve() drives, with assertions where the device
    state would be; tokens come back as a tensor, as the port's engine
    returns them, and encode (request id, step index)."""

    def __init__(self, max_slots, max_len=64):
        self.max_slots, self.max_len = max_slots, max_len
        self.session = None
        self.n_prefills = 0
        self.left = [0] * max_slots
        self.occupant = [-1] * max_slots
        self.count = [0] * max_slots

    def prefill(self, request, temperature=0.0):
        self.n_prefills += 1
        rid = int(request.prompt[0])
        L = max(1, min(len(request.prompt), self.max_len - 1))
        max_new = max(1, min(request.max_new_tokens, self.max_len - L))
        return _FakePrefix(rid, torch.tensor(rid * 1000), L, max_new,
                           temperature)

    def insert(self, prefix, slot):
        assert self.left[slot] == 0, "slot leak: insert into occupied slot"
        self.occupant[slot] = prefix.state
        self.left[slot] = prefix.max_new - 1
        self.count[slot] = 0

    def generate_step(self, active=None):
        act = np.asarray(active, bool)
        toks = torch.zeros(self.max_slots, dtype=torch.int64)
        for s in range(self.max_slots):
            if act[s]:
                assert self.left[s] > 0, "stepping a finished slot"
                self.count[s] += 1
                self.left[s] -= 1
                toks[s] = self.occupant[s] * 1000 + self.count[s]
        return toks

    def observe(self, n_prefills, n_decode=1, wall_s=None):
        return None


def _run_fake(n, slots, lens, budgets, arrivals):
    reqs = [Request(np.full(int(l), i, np.int64), max_new_tokens=int(m))
            for i, (l, m) in enumerate(zip(lens, budgets))]
    eng = _FakeEngine(slots)
    rep = serve(eng, reqs, arrivals=arrivals)
    assert eng.n_prefills == n
    assert all(left == 0 for left in eng.left), "pool did not drain"
    for i, out in enumerate(rep.outputs):
        L = max(1, min(int(lens[i]), eng.max_len - 1))
        m = max(1, min(int(budgets[i]), eng.max_len - L))
        assert out.tolist() == [i * 1000 + k for k in range(m)]
    assert rep.tokens_out == sum(len(o) for o in rep.outputs)
    if n:
        # a run where no request decodes (every budget is 1) steps the pool
        # no time: occupancy is 0 then (ROADMAP §C5)
        decodes = any(len(o) > 1 for o in rep.outputs)
        assert (0 < rep.occupancy_mean <= slots) if decodes \
            else rep.occupancy_mean == 0
    return rep


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_scheduler_slot_invariants(data):
    n = data.draw(st.integers(0, 25), label="n_requests")
    slots = data.draw(st.integers(1, 6), label="slots")
    lens = data.draw(st.lists(st.integers(1, 20), min_size=n, max_size=n))
    budgets = data.draw(st.lists(st.integers(1, 9), min_size=n, max_size=n))
    gaps = data.draw(st.lists(st.floats(0.0, 4.0), min_size=n, max_size=n))
    _run_fake(n, slots, lens, budgets,
              np.cumsum(np.asarray(gaps)) if n else [])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_slot_invariants_deterministic(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 25))
    rep = _run_fake(n, int(rng.integers(1, 6)), rng.integers(1, 20, n),
                    rng.integers(1, 9, n), np.cumsum(rng.exponential(1.5, n)))
    assert len(rep.outputs) == n


def test_scheduler_when_no_request_decodes():
    rep = _run_fake(3, 2, [4, 4, 4], [1, 1, 1], [0.0, 0.5, 3.0])
    assert rep.n_steps == 0 and rep.occupancy_mean == 0


def test_serve_rejects_mismatched_arrivals():
    with pytest.raises(ValueError, match="arrival times"):
        serve(_FakeEngine(2), [Request(np.array([0]), 2)], arrivals=[0, 1])
