"""End-to-end training loop: energy-aware runtime + fault tolerance, on
one card.

Per step: run the train step, feed its roofline profile to the selected
power policy through an ``EnergySession``, record telemetry, checkpoint on
the configured cadence and watch for stragglers. Restart resumes from the
latest committed checkpoint with byte-identical data.

    python -m repro_torch.launch.train --arch stablelm-12b --steps 30 \\
        --reduced --policy energy-aware              # on the card
    python -m repro_torch.launch.train --arch stablelm-12b --steps 3 \\
        --reduced --device cpu                       # on the host

``--reduced`` trains the arch's tiny same-family config in f32 on the
shape's reduced size. Parameters are drawn from a generator seeded with
``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device
from repro_torch.checkpoint import Checkpointer, restore
from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig, get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.roofline import model_flops
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import torch_dtype
from repro_torch.models.transformer import Runtime
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.optim.compression import init_error_state
from repro_torch.power import EnergySession, StepProfile
from repro_torch.power.policies import PolicyLike


class StragglerWatchdog:
    """EWMA step-time tracker per host; hosts persistently beyond
    ``threshold`` x the fleet median are flagged for eviction at the next
    checkpoint boundary."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.3):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Dict[int, float] = {}

    def record(self, host: int, step_time_s: float) -> None:
        prev = self.ewma.get(host, step_time_s)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s

    def stragglers(self) -> list:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        return [h for h, v in self.ewma.items()
                if v > self.threshold * med]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 30
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 10
    policy: PolicyLike = None           # name, PowerPolicy object, or None
    governor: bool = False              # deprecated alias: policy="energy-aware"
    slowdown_budget: float = 0.0
    freq_mhz: Optional[int] = None      # knob for policy="static"
    power_cap_w: Optional[float] = None  # knob for policy="power-cap"
    seed: int = 0
    log_every: int = 5

    def resolved_policy(self) -> PolicyLike:
        if self.policy is not None:
            return self.policy
        return "energy-aware" if self.governor else "nominal"


class Trainer:
    """Trains ``cfg`` on ``shape``'s synthetic batches on ``device`` (the
    card by default). The state is ``{"params", "opt"}``, plus
    ``grad_error`` when ``opt_cfg.grad_compression`` is ``"int8"``; the
    moments are in ``opt_cfg.moment_dtype``."""

    def __init__(self, cfg, shape: ShapeConfig, rt: Runtime,
                 opt_cfg: OptConfig = OptConfig(),
                 tcfg: TrainConfig = TrainConfig(), device=None):
        self.cfg, self.shape, self.rt = cfg, shape, rt
        self.opt_cfg, self.tcfg = opt_cfg, tcfg
        self.device = as_device(device)
        self.session = EnergySession(
            policy=tcfg.resolved_policy(), chip=H100_SXM, window_s=15.0,
            slowdown_budget=tcfg.slowdown_budget, freq_mhz=tcfg.freq_mhz,
            cap_w=tcfg.power_cap_w, device=self.device)
        self.telemetry = self.session.telemetry
        self.watchdog = StragglerWatchdog()
        self.checkpointer = (Checkpointer(tcfg.ckpt_dir, tcfg.ckpt_interval)
                             if tcfg.ckpt_dir else None)
        self.pipeline = SyntheticPipeline(cfg, shape, seed=tcfg.seed)
        self._step_fn = steps_mod.make_train_step(cfg, rt, opt_cfg)
        self.start_step = 0
        self.state = None
        self.history: list = []

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tcfg.seed)
        params = model_mod.init_params(self.cfg, self.rt, gen,
                                       device=self.device)
        state = {"params": params, "opt": init_opt_state(
            params, moment_dtype=self.opt_cfg.moment_dtype)}
        if self.opt_cfg.grad_compression == "int8":
            state["grad_error"] = init_error_state(params)
        if self.checkpointer is not None:
            latest = self.checkpointer.latest()
            if latest is not None:
                state = restore(self.checkpointer.dir, latest, state)
                self.start_step = latest
                print(f"[restart] resumed from step {latest}", flush=True)
        self.state = state

    def _device_batch(self, step: int) -> Dict:
        """The pipeline's batch at ``step`` on the device; the frontend in
        the config's dtype, as the model reads it."""
        batch = self.pipeline.batch_at(step)
        out = {"tokens": torch.from_numpy(batch["tokens"]).to(self.device)}
        if "frontend" in batch:
            out["frontend"] = torch.from_numpy(batch["frontend"]).to(
                device=self.device, dtype=torch_dtype(self.cfg.dtype))
        return out

    def _step_profile(self) -> StepProfile:
        """The step's roofline profile on the H100 from the model's flops
        (forward and backward, 3x the forward's); the memory term at 0.6 of
        it, as the reference prices its step."""
        compute_s = model_flops(self.cfg, self.shape) * 3 / H100_SXM.peak_flops
        return StepProfile(compute_s=compute_s, memory_s=compute_s * 0.6,
                           collective_s=0.0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict:
        if self.state is None:
            self.init_or_restore()
        losses = []
        profile = self._step_profile()
        energy_aware = self.session.policy.name != "nominal"
        for step in range(self.start_step, self.tcfg.steps):
            batch = self._device_batch(step)
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics = self._step_fn(self.state, batch)
            self._sync()
            wall = time.perf_counter() - t0
            self.watchdog.record(0, wall)      # one host
            d = self.session.observe(step, profile, wall)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.history.append({"step": step, "loss": loss, "wall_s": wall})
            if energy_aware:
                self.history[-1]["gov"] = {
                    "freq_mhz": d.freq_mhz, "savings_pct": d.savings_pct}
            if self.checkpointer is not None:
                self.checkpointer.maybe_save(step + 1, self.state)
            if step % self.tcfg.log_every == 0:
                extra = (f" f={d.freq_mhz}MHz sav={d.savings_pct:.1f}%"
                         if energy_aware else "")
                print(f"step {step:5d} loss {loss:.4f} "
                      f"wall {wall*1e3:.0f}ms{extra}", flush=True)
        if self.checkpointer is not None:
            self.checkpointer.maybe_save(self.tcfg.steps, self.state,
                                         force=True)
            self.checkpointer.wait()
        return {"losses": losses,
                "stragglers": self.watchdog.stragglers(),
                "energy_j": self.session.total_energy_j()}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config in f32 on the "
                         "shape's reduced size")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--policy", default=None,
                    choices=["nominal", "static", "power-cap",
                             "energy-aware"],
                    help="power policy (see repro_torch.power.POLICIES)")
    ap.add_argument("--governor", action="store_true",
                    help="deprecated: same as --policy energy-aware")
    ap.add_argument("--slowdown-budget", type=float, default=0.0)
    ap.add_argument("--freq-mhz", type=int, default=None,
                    help="set-point for --policy static")
    ap.add_argument("--power-cap-w", type=float, default=None,
                    help="cap for --policy power-cap")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with "
                         "--reduced) to train on the host")
    cfg = get_config(args.arch)
    shape = SHAPES_BY_NAME[args.shape]
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        shape = shape.reduced()
    rt = Runtime(tp=1, moe_impl="local")
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_interval=args.ckpt_interval,
                       policy=args.policy, governor=args.governor,
                       slowdown_budget=args.slowdown_budget,
                       freq_mhz=args.freq_mhz,
                       power_cap_w=args.power_cap_w, seed=args.seed)
    trainer = Trainer(cfg, shape, rt, tcfg=tcfg, device=device)
    out = trainer.run()
    print(f"final loss {out['losses'][-1]:.4f}  "
          f"energy {out['energy_j']/1e3:.1f} kJ  "
          f"stragglers {out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
