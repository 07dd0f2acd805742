"""Data pipeline: deterministic, shardable, resumable (mirror of
``repro/data/pipeline.py``).

Two sources behind one interface:
  * SyntheticSource: uniform random tokens keyed by (seed, step, host);
    zero I/O, fully deterministic, used by smoke runs. It is the port's
    own: the JAX package draws with ``jax.random``, whose bits torch and
    numpy cannot reproduce, so the two packages' synthetic streams differ
    (parity tests feed both the same ``MemmapSource`` file instead).
  * MemmapSource: flat token .bin on disk (np.uint16/uint32 memmap),
    sequence-chunked; the same deterministic mapping (step, host) -> file
    offsets as the JAX package, so both packages read identical batches
    and restarting at step k reproduces the stream.

Batches are {"tokens": [B, S], "targets": [B, S]} int32 CPU tensors with
targets = next-token shift; the caller moves them to its device. Each host
materializes only its batch shard (host_index / host_count).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None  # memmap .bin (None -> synthetic)
    dtype: str = "uint16"


def _batch(toks: np.ndarray) -> dict:
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}


class SyntheticSource:
    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count

    def batch_at(self, step: int) -> dict:
        """Tokens uniform in [0, vocab) from
        ``np.random.default_rng((seed, step, host_index))``."""
        cfg = self.cfg
        b_loc = cfg.global_batch // self.host_count
        rng = np.random.default_rng((cfg.seed, step, self.host_index))
        toks = rng.integers(0, cfg.vocab_size, size=(b_loc, cfg.seq_len + 1),
                            dtype=np.int32)
        return _batch(toks)


class MemmapSource:
    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.path is None:
            raise ValueError("MemmapSource needs DataConfig.path")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.data = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
        self.n_seqs = (len(self.data) - 1) // cfg.seq_len
        if self.n_seqs < 1:
            raise ValueError("dataset smaller than one sequence")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        b_loc = cfg.global_batch // self.host_count
        base = step * cfg.global_batch + self.host_index * b_loc
        rows = [(base + i) % self.n_seqs for i in range(b_loc)]
        toks = np.stack([
            self.data[r * cfg.seq_len:(r + 1) * cfg.seq_len + 1]
            for r in rows]).astype(np.int32)
        toks = np.minimum(toks, cfg.vocab_size - 1)
        return _batch(toks)


class DataLoader:
    """Step-indexed loader with checkpointable position."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1, start_step: int = 0):
        src_cls = MemmapSource if cfg.path else SyntheticSource
        self.source = src_cls(cfg, host_index, host_count)
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.source.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])


def write_token_bin(path: str, n_tokens: int, vocab_size: int,
                    seed: int = 0, dtype: str = "uint16") -> str:
    """Generate a token .bin for examples/tests (the JAX package's
    generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, min(vocab_size, np.iinfo(np.dtype(dtype)).max),
                       size=(n_tokens,), dtype=np.dtype(dtype))
    arr.tofile(path)
    return path
