"""Atomic, async checkpoints in the JAX package's on-disk format
(counterpart of ``repro.checkpoint.manager``): a checkpoint written by
either package restores in the other.

Layout of a checkpoint directory::

    <root>/step_000000123/
        metadata.json          # step, and each leaf's name, shape and dtype
        shard_000.npz ...      # leaves chunked along their first axis
    <root>/step_000000123.COMMIT  # written last: marks the checkpoint complete

* leaf names join the tree path with ``$``: dict keys in sorted order,
  NamedTuple fields as ``.field``, sequence items by index, so
  ``(params, opt_state)`` gives ``0$embed`` and ``1$.m$embed``
  (``repro_torch.tree``);
* a leaf with ``shape[0] >= chunks`` is split along axis 0 into
  ``<name>$chunk<ci>`` pieces, one per shard; other leaves go to shard 0;
* bfloat16 is widened to float32 on disk (npz has none) and recorded as
  ``"bfloat16"`` in the metadata;
* the directory is staged as ``.tmp_step_…`` and renamed into place before
  the COMMIT marker is written, so a crash mid-save leaves nothing that
  ``restore`` would pick up; the newest ``keep`` checkpoints are kept.

``save_async`` copies every tensor to the host before it returns and
writes in a background thread: the port's optimizer updates parameters and
moments in place (JAX arrays are immutable), so a later step cannot change
what is being written.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

PyTree = Any
_SEP = "$"
HostLeaf = Tuple[str, np.ndarray, str]  # name, array as written, dtype recorded


def _flatten_with_names(t: PyTree) -> List[Tuple[str, Any]]:
    return [(_SEP.join(str(p) for p in path), leaf) for path, leaf in tree.leaves_with_path(t)]


def _to_host(name: str, leaf) -> HostLeaf:
    """A copy of ``leaf`` on the host that later in-place updates cannot
    reach; bfloat16 comes back widened to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return name, t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return name, arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, chunks: int = 4):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.chunks = chunks
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()

    def close(self) -> None:
        """Wait for pending asynchronous saves and stop the writer thread."""
        self._pool.shutdown(wait=True)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, t: PyTree) -> None:
        self._write(step, [_to_host(n, leaf) for n, leaf in _flatten_with_names(t)])

    def save_async(self, step: int, t: PyTree) -> Future:
        host = [_to_host(n, leaf) for n, leaf in _flatten_with_names(t)]
        return self._pool.submit(self._write, step, host)

    def _write(self, step: int, host: List[HostLeaf]) -> None:
        with self._lock:
            d = self.root / f"step_{step:09d}"
            tmp = self.root / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            meta = {"step": step, "leaves": []}
            shard_payloads: List[Dict[str, np.ndarray]] = [{} for _ in range(self.chunks)]
            for name, arr, dtype in host:
                meta["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": dtype})
                if arr.ndim == 0 or arr.shape[0] < self.chunks:
                    shard_payloads[0][name] = arr
                    continue
                for ci, piece in enumerate(np.array_split(arr, self.chunks, axis=0)):
                    shard_payloads[ci][f"{name}{_SEP}chunk{ci}"] = piece
            for ci, payload in enumerate(shard_payloads):
                np.savez(tmp / f"shard_{ci:03d}.npz", **payload)
            (tmp / "metadata.json").write_text(json.dumps(meta))
            if d.exists():
                shutil.rmtree(d)
            os.rename(tmp, d)
            (self.root / f"step_{step:09d}.COMMIT").touch()
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)
            (self.root / f"step_{s:09d}.COMMIT").unlink(missing_ok=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(f.stem.split("_")[1]) for f in self.root.glob("step_*.COMMIT"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: PyTree, step: Optional[int] = None) -> Tuple[int, PyTree]:
        """Restore into the structure of ``target``: every leaf's shape is
        checked, and each comes back as a tensor of the target leaf's dtype
        on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        d = self.root / f"step_{step:09d}"
        raw: Dict[str, np.ndarray] = {}
        for f in sorted(d.glob("shard_*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    raw[k] = z[k]
        meta = json.loads((d / "metadata.json").read_text())
        arrays: Dict[str, np.ndarray] = {}
        for leaf in meta["leaves"]:
            name = leaf["name"]
            if name in raw:
                arrays[name] = raw[name]
            else:
                pieces = [raw[f"{name}{_SEP}chunk{ci}"] for ci in range(self.chunks)
                          if f"{name}{_SEP}chunk{ci}" in raw]
                arrays[name] = np.concatenate(pieces, axis=0)
        out = []
        for name, tgt in _flatten_with_names(target):
            arr = arrays[name]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != target {tuple(tgt.shape)}")
            out.append(torch.from_numpy(arr).to(device=tgt.device, dtype=tgt.dtype))
        return step, tree.unflatten(target, out)
