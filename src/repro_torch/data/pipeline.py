"""Deterministic, shardable synthetic data pipeline (the port's own copy
of ``repro.data.pipeline``: the same batches, bit for bit, for the same
``DataConfig`` and step).

Production shape without production data: batches are generated from a
counter-based PRNG (stateless — batch ``i`` is a pure function of (seed, i)),
which gives the three properties a multi-pod pipeline needs:

* **determinism / resumability** — restart at step k reproduces batch k
  exactly (no state to checkpoint beyond the step counter);
* **host sharding** — each host materialises only its slice of the global
  batch (``host_slice``), no cross-host data traffic;
* **prefetch** — a background thread keeps ``prefetch`` batches ready.

The token distribution is a Zipfian mixture with short-range structure so
losses are non-degenerate (pure uniform tokens make CE trivially flat).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    num_hosts: int = 1
    host_index: int = 0
    prefetch: int = 2


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step, host)
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    # Zipf-ish marginal + Markov-ish local structure
    base = rng.zipf(1.3, size=shape).astype(np.int64)
    tokens = (base - 1) % vocab
    # short-range structure: with p=0.3 repeat previous token + 1
    rep = rng.random(shape) < 0.3
    shifted = np.roll(tokens, 1, axis=-1)
    tokens = np.where(rep, (shifted + 1) % vocab, tokens)
    return tokens.astype(np.int32)


def host_slice(cfg: DataConfig) -> Tuple[int, int]:
    assert cfg.global_batch % cfg.num_hosts == 0
    per = cfg.global_batch // cfg.num_hosts
    return cfg.host_index * per, per


def make_batch(arch: ArchConfig, cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for a given step — this host's slice only."""
    start, per = host_slice(cfg)
    rng = _rng_for(cfg.seed, step, cfg.host_index)
    if arch.frontend == "audio":
        frames = rng.standard_normal((per, cfg.seq_len, arch.d_model)).astype(np.float32)
        targets = _zipf_tokens(rng, (per, cfg.seq_len, arch.n_codebooks), arch.vocab_size)
        return {"frame_embeds": frames, "targets": targets}
    out = {"tokens": _zipf_tokens(rng, (per, cfg.seq_len), arch.vocab_size)}
    if arch.frontend == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (per, arch.num_patches, arch.d_model)
        ).astype(np.float32)
    return out


class DataPipeline:
    """Prefetching iterator over deterministic batches."""

    def __init__(self, arch: ArchConfig, cfg: DataConfig, start_step: int = 0):
        self.arch = arch
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = make_batch(self.arch, self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
