"""Serving engines: a slot-based continuous-batching engine plus the blocking
facade.

:class:`ContinuousEngine` is the JetStream-style core — ``prefill(request)
-> Prefix``, ``insert(prefix, slot)``, ``generate_step()`` — over a fixed
pool of decode slots. Each slot carries its own KV rows, position, last
token and sampling temperature in tensors on the card; one decode step
advances every occupied slot with per-sequence position/length masking, so
a short prompt's continuation never depends on its batch-mates. ``insert``
and ``generate_step`` update the slot pool's cache in place (slice
assignment and ``index_copy_``), where the reference donates buffers to
jitted updates.

The energy hook is the point (the paper's per-phase DVFS headroom): prefill
is compute-bound, decode is memory-bound, and the engine reports each as its
own roofline :class:`StepProfile` — derived from the model config through
the chip model — so any policy behind an :class:`EnergySession` caps the
decode phase deep while leaving prefill at nominal.

:class:`ServeEngine.generate` keeps its blocking signature: greedy calls
of the dense and MoE families route through the continuous engine;
sampling, calls with an ``extra_batch`` (the VLM's image, the enc-dec's
audio frames), and every call of the families outside
:data:`SLOT_FAMILIES` (the recurrent ones have no position-indexed cache
to fill a slot from; the slot pool holds no memory for the VLM's or
enc-dec's cross-attention) take the lock-step path
(:meth:`ServeEngine.generate_blocking`), which reads logits and decodes at
per-sequence positions for heterogeneous prompt lengths of the families
with a position-indexed cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import roofline
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel, StepProfile
from repro_torch.models import decode as decode_mod
from repro_torch.models.transformer import Runtime
from repro_torch.power.session import EnergySession

#: families the slot engine can serve: per-slot KV rows are written at
#: per-sequence positions
SLOT_FAMILIES = ("dense", "moe")


# ---------------------------------------------------------------------------
# Roofline profiles for the two serving phases
# ---------------------------------------------------------------------------
def serving_profiles(cfg: ModelConfig, chip=H100_SXM, batch: int = 8,
                     prompt_len: int = 512, context_len: int = 2048,
                     chips: int = 1) -> Tuple[StepProfile, StepProfile]:
    """(prefill, decode) :class:`StepProfile` pair for this model on this
    chip, from the analytic rooflines: FLOPs-per-step over peak for the
    compute term, weights+cache bytes over HBM bandwidth for the memory
    term."""
    spec: ChipSpec = ChipModel(chip).spec
    out = []
    for kind, seq in (("prefill", prompt_len), ("decode", context_len)):
        shape = ShapeConfig(f"serve_{kind}", seq, batch, kind)
        out.append(StepProfile(
            compute_s=roofline.model_flops(cfg, shape)
            / (chips * spec.peak_flops),
            memory_s=roofline.memory_floor_s(cfg, shape, chips, spec)))
    return out[0], out[1]


def scale_profile(profile: StepProfile, wall_s: float) -> StepProfile:
    """Rescale a derived profile so its nominal step time equals a measured
    wall-clock: the roofline *position* comes from the model config, the
    magnitude from the measurement."""
    r = wall_s / profile.total_s
    return StepProfile(compute_s=profile.compute_s * r,
                       memory_s=profile.memory_s * r,
                       collective_s=profile.collective_s * r)


def _sample_tokens(logits: torch.Tensor, temperature,
                   generator: Optional[torch.Generator] = None,
                   any_sampled: Optional[bool] = None) -> torch.Tensor:
    """Greedy/categorical per row: logits [B,V], temperature scalar or [B]
    (0 = greedy). ``any_sampled`` tells whether some row samples (known on
    the host, so an all-greedy batch skips the draw without a device
    sync)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).expand(logits.shape[:-1])
    if any_sampled is None:
        any_sampled = bool((t > 0.0).any())
    if not any_sampled:
        return greedy
    probs = torch.softmax(
        logits.float() / torch.clamp(t, min=1e-6)[..., None], dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[..., 0]
    return torch.where(t > 0.0, sampled.to(torch.int32), greedy)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Request:
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16


@dataclass
class Prefix:
    """A prefilled prompt, ready for :meth:`ContinuousEngine.insert`: the
    per-layer cache rows for one sequence (padded to the prompt page), the
    first sampled token, and the slot bookkeeping that travels with it."""
    state: Any                    # cache dict, batch dim 1, seq dim = page
    token: torch.Tensor           # [] int32, sampled from the prompt logits
    length: int                   # true prompt length
    max_new: int                  # decode budget (first token included)
    temperature: float = 0.0


class ContinuousEngine:
    """Fixed pool of ``max_slots`` decode slots on the parameters' device.

    ``prefill`` runs one prompt (right-padded only to its power-of-two page)
    and samples the first token; ``insert`` writes the prefix rows into a
    free slot; ``generate_step`` advances every slot one token with per-slot
    positions and sampling temperatures. A scheduler (see
    :func:`repro_torch.serving.serve`) admits queued requests into freed
    slots between steps — continuous batching.

    With a ``session``, each scheduler tick reports its prefill count and
    decode step as distinct roofline profiles via ``observe_many``."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, params,
                 max_slots: int = 8, max_len: int = 256, page: int = 16,
                 session: Optional[EnergySession] = None,
                 prefill_profile: Optional[StepProfile] = None,
                 decode_profile: Optional[StepProfile] = None,
                 seed: int = 0):
        if cfg.family not in SLOT_FAMILIES:
            raise ValueError(
                f"continuous batching needs per-slot position-indexed KV "
                f"(families {SLOT_FAMILIES}); family {cfg.family!r} is "
                f"served by ServeEngine.generate")
        self.cfg, self.rt, self.params = cfg, rt, params
        self.max_slots, self.max_len, self.page = max_slots, max_len, page
        self.session = session
        if prefill_profile is None or decode_profile is None:
            chip = session.chip if session is not None else H100_SXM
            pre, dec = serving_profiles(cfg, chip=chip, batch=max_slots,
                                        context_len=max_len)
            prefill_profile = prefill_profile or pre
            decode_profile = decode_profile or dec
        self.prefill_profile, self.decode_profile = (prefill_profile,
                                                     decode_profile)
        self.device = params["emb"].device
        dev = self.device
        # per-slot state on the card, updated in place
        self._state = decode_mod.init_decode_state(cfg, rt, max_slots,
                                                   max_len, device=dev)
        self._pos = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)
        self._temps = torch.zeros((max_slots,), dtype=torch.float32,
                                  device=dev)
        self._host_temps = np.zeros((max_slots,), np.float32)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._all_active = torch.ones((max_slots,), dtype=torch.bool,
                                      device=dev)
        self.n_prefills = 0
        self.n_steps = 0

    # ------------------------------------------------------------- prefill
    def _bucket(self, length: int) -> int:
        """Prompt page: the smallest power-of-two >= length (floor =
        ``page``), capped at ``max_len``."""
        b = max(self.page, 1)
        while b < length:
            b *= 2
        return min(b, self.max_len)

    def prefill(self, request: Request, temperature: float = 0.0) -> Prefix:
        """Run one prompt through the trunk; returns the :class:`Prefix`
        (cache rows at its page size + first sampled token)."""
        prompt = np.asarray(request.prompt, np.int32)[: self.max_len - 1]
        L = max(len(prompt), 1)
        page = self._bucket(L)
        toks = np.zeros((1, page), np.int32)
        toks[0, :len(prompt)] = prompt
        tokens = torch.from_numpy(toks).to(self.device)
        length = torch.tensor([L], dtype=torch.int32, device=self.device)
        logits, state = decode_mod.prefill(
            self.cfg, self.rt, self.params, {"tokens": tokens}, page,
            lengths=length)
        tok = _sample_tokens(logits[:, 0, :self.cfg.vocab_size],
                             temperature, self._gen,
                             any_sampled=temperature > 0.0)
        self.n_prefills += 1
        max_new = max(1, min(request.max_new_tokens, self.max_len - L))
        return Prefix(state=state, token=tok[0], length=L, max_new=max_new,
                      temperature=temperature)

    # -------------------------------------------------------------- insert
    def insert(self, prefix: Prefix, slot: int) -> None:
        """Write the prefix rows into ``slot`` (in place) and arm its
        position, last token and sampling temperature."""
        for name, rows in prefix.state["layers"].items():
            page = rows.shape[2]
            self._state["layers"][name][:, slot, :page] = rows[:, 0]
        self._pos[slot] = prefix.length
        self._tokens[slot] = prefix.token
        self._temps[slot] = prefix.temperature
        self._host_temps[slot] = prefix.temperature

    # ------------------------------------------------------ generate_step
    def generate_step(self, active=None) -> torch.Tensor:
        """Advance every (active) slot one token; returns the [max_slots]
        int32 tokens sampled this step (inactive entries are meaningless).
        Inactive slots hold position and token; their cache writes land on
        rows that are never attended."""
        act = (self._all_active if active is None
               else torch.as_tensor(np.asarray(active, bool),
                                    device=self.device))
        logits, self._state = decode_mod.decode_step(
            self.cfg, self.rt, self.params, self._tokens[:, None],
            self._pos, self._state)
        nxt = _sample_tokens(logits[:, 0, :self.cfg.vocab_size],
                             self._temps, self._gen,
                             any_sampled=bool((self._host_temps > 0).any()))
        self._pos += act.to(torch.int32)
        self._tokens = torch.where(act, nxt, self._tokens)
        self.n_steps += 1
        return nxt

    # ------------------------------------------------------------- energy
    def observe(self, n_prefills: int, n_decode: int = 1,
                wall_s: Optional[float] = None):
        """Report one scheduler tick to the session: ``n_prefills``
        compute-bound prefill profiles + ``n_decode`` memory-bound decode
        profiles, one vectorized policy pass."""
        if self.session is None:
            return None
        profiles = ([self.prefill_profile] * n_prefills
                    + [self.decode_profile] * n_decode)
        if not profiles:
            return None
        return self.session.observe_many(profiles, wall_s=wall_s)


class ServeEngine:
    """Blocking batch facade over the serving substrate. Greedy calls of
    :data:`SLOT_FAMILIES` without an ``extra_batch`` route through a pooled
    :class:`ContinuousEngine`; temperature sampling, frontends and the other
    families take the lock-step path."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, params,
                 max_len: int = 256,
                 session: Optional[EnergySession] = None,
                 profile: Optional[StepProfile] = None):
        self.cfg, self.rt, self.params = cfg, rt, params
        self.max_len = max_len
        self.session = session
        self.profile = profile      # decode-step roofline profile (if known)
        self.device = params["emb"].device
        self._cont: Dict[int, ContinuousEngine] = {}  # slot pools, by batch
        self._derived_decode: Optional[StepProfile] = None

    def _decode_roofline(self) -> StepProfile:
        """Decode-phase profile derived from the model config via the chip
        roofline; scaled to the measured wall-clock per step at observe
        time."""
        if self._derived_decode is None:
            chip = self.session.chip if self.session is not None \
                else H100_SXM
            self._derived_decode = serving_profiles(
                self.cfg, chip=chip, batch=1, context_len=self.max_len)[1]
        return self._derived_decode

    def generate(self, requests: List[Request], temperature: float = 0.0,
                 seed: int = 0, extra_batch: Optional[Dict] = None
                 ) -> List[np.ndarray]:
        """Generate for a batch of requests, blocking until all are done
        (every output is ``max(r.max_new_tokens)`` long; per-request budgets
        need :func:`repro_torch.serving.serve`).

        ``extra_batch`` holds what the prefill reads besides the tokens: a
        VLM's or enc-dec's ``"frontend"`` ``[B, F, d_model]`` (the image's
        patch or the audio's frame embeddings, in the config's dtype). A
        call with it takes the lock-step route, as every call of the
        families outside :data:`SLOT_FAMILIES` does."""
        if (self.cfg.family in SLOT_FAMILIES and temperature <= 0.0
                and extra_batch is None):
            return self._generate_continuous(requests, seed)
        return self.generate_blocking(requests, temperature, seed,
                                      extra_batch)

    # ---------------------------------------------------- continuous route
    def _generate_continuous(self, requests: List[Request],
                             seed: int) -> List[np.ndarray]:
        B = len(requests)
        eng = self._cont.get(B)
        if eng is None:
            eng = self._cont[B] = ContinuousEngine(
                self.cfg, self.rt, self.params, max_slots=B,
                max_len=self.max_len, seed=seed)
        eng._gen.manual_seed(seed)
        plen = min(max(len(r.prompt) for r in requests), self.max_len - 1)
        max_new = min(max(r.max_new_tokens for r in requests),
                      self.max_len - plen)
        outs = [[] for _ in range(B)]
        for i, r in enumerate(requests):
            pf = eng.prefill(r)
            eng.insert(pf, i)
            outs[i].append(int(pf.token))
        walls: List[float] = []
        # max_new decode calls (the last one's sample is discarded, as the
        # lock-step loop does) -> the same telemetry cadence
        for i in range(max_new):
            t0 = time.perf_counter()
            toks = eng.generate_step().cpu().numpy()
            wall = time.perf_counter() - t0
            walls.append(wall)
            if i + 1 < max_new:
                for b in range(B):
                    outs[b].append(int(toks[b]))
            if self.session is not None and self.profile is None:
                self.session.observe(
                    i, scale_profile(self._decode_roofline(), wall), wall)
        if self.session is not None and self.profile is not None:
            self.session.observe_many([self.profile] * max_new,
                                      wall_s=walls, start_step=0)
        return [np.asarray(o, np.int32) for o in outs]

    # ----------------------------------------------------- lock-step route
    def generate_blocking(self, requests: List[Request],
                          temperature: float = 0.0, seed: int = 0,
                          extra_batch: Optional[Dict] = None
                          ) -> List[np.ndarray]:
        """One right-padded prefill, then every sequence decodes in
        lock-step to the batch-max budget. Kept public as the baseline the
        continuous engine is compared against. ``extra_batch`` (a
        frontend) joins the prefill's batch, on the engine's device."""
        B = len(requests)
        dev = self.device
        plen = min(max(len(r.prompt) for r in requests), self.max_len - 1)
        prompts = np.zeros((B, plen), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, r in enumerate(requests):
            p = np.asarray(r.prompt[:plen])
            prompts[i, :len(p)] = p
            lengths[i] = len(p)
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}
        if extra_batch:
            batch.update({k: torch.as_tensor(v, device=dev)
                          for k, v in extra_batch.items()})
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        # per-sequence masking for heterogeneous batches; the uniform case
        # keeps the scalar-position path
        masked = (lengths.min() != lengths.max()
                  and self.cfg.family in decode_mod.CAUSAL_CACHE_FAMILIES)
        if masked:
            base_pos = torch.from_numpy(lengths).to(dev)
            logits, state = decode_mod.prefill(
                self.cfg, self.rt, self.params, batch, self.max_len,
                lengths=base_pos)
        else:
            base_pos = None
            logits, state = decode_mod.prefill(
                self.cfg, self.rt, self.params, batch, self.max_len)
        max_new = min(max(r.max_new_tokens for r in requests),
                      self.max_len - plen)
        outs = []
        walls: List[float] = []
        for i in range(max_new):
            tok = _sample_tokens(logits[:, 0, :self.cfg.vocab_size],
                                 temperature, gen,
                                 any_sampled=temperature > 0.0)
            outs.append(tok.cpu().numpy())
            pos = (torch.tensor(plen + i, dtype=torch.int32, device=dev)
                   if base_pos is None else base_pos + i)
            t0 = time.perf_counter()
            logits, state = decode_mod.decode_step(
                self.cfg, self.rt, self.params, tok[:, None], pos, state)
            _sync(dev)
            wall = time.perf_counter() - t0
            walls.append(wall)
            if self.session is not None and self.profile is None:
                self.session.observe(
                    i, scale_profile(self._decode_roofline(), wall), wall)
        if self.session is not None and self.profile is not None:
            self.session.observe_many([self.profile] * max_new,
                                      wall_s=walls, start_step=0)
        gen_toks = np.stack(outs, axis=1)                # [B, max_new]
        return [gen_toks[i] for i in range(B)]
