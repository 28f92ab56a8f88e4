"""Checkpoint/restart substrate.

* step-indexed directories ``step_N/`` holding ``state.npz`` and
  ``meta.json``, written into ``.tmp_step_N/`` and committed with an atomic
  ``os.replace`` (a crash mid-write never corrupts the latest checkpoint);
* latest-step discovery for restart after a failure;
* a background-thread save (training goes on while the previous step
  serialises), one write in flight, the oldest steps beyond ``keep``
  removed.

State is a tree of tensors (:mod:`repro_torch.tree`); each leaf is stored
under its path (``params/layers/0/attn/wq``). numpy has no bf16, so a bf16
leaf is stored as its bits (``uint16``) and ``meta.json`` names its dtype;
:func:`restore` gives back the same dtype and the same bits, on the device
of the ``like`` leaf. The reference's resharded restore onto another mesh
(``shardings=``) belongs to the multi-device half of ROADMAP queue A item
6.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")

PathLike = Union[str, pathlib.Path]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: PathLike, step: int, state: Any,
         extra: Optional[Dict] = None) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = dict(leaves_with_paths(state))
    np.savez(tmp / "state.npz", **{k: _to_numpy(v) for k, v in flat.items()})
    meta = {"step": step, "keys": sorted(flat),
            "bfloat16": sorted(k for k, v in flat.items()
                               if v.dtype == torch.bfloat16),
            "extra": extra or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)      # atomic commit
    return final


def latest_step(ckpt_dir: PathLike) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := _STEP_RE.match(p.name))]
    return max(steps) if steps else None


def restore(ckpt_dir: PathLike, step: int, like: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf in ``like``'s dtype on ``like``'s device."""
    if shardings is not None:
        raise NotImplementedError(
            "restore onto shardings belongs to ROADMAP queue A item 6: the "
            "multi-device half")
    path = pathlib.Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((path / "meta.json").read_text())
    bf16 = set(meta.get("bfloat16", ()))
    out = []
    with np.load(path / "state.npz") as data:
        for key, leaf in leaves_with_paths(like):
            arr = data[key]
            if key in bf16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, out)


class Checkpointer:
    """Async checkpointer: ``maybe_save`` returns once the state is copied
    to the host; the previous save is joined before a new one starts
    (single in-flight write). A save that failed in the background raises
    from the next :meth:`wait`."""

    def __init__(self, ckpt_dir: PathLike, interval: int = 50,
                 keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.interval = interval
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, state: Any,
                   extra: Optional[Dict] = None,
                   force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        host_state = tree_map(lambda t: t.detach().to("cpu", copy=True),
                              state)

        def _work():
            try:
                save(self.dir, step, host_state, extra)
                self._gc()
            except BaseException as exc:   # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for p in self.dir.iterdir()
            if (m := _STEP_RE.match(p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.dir)
