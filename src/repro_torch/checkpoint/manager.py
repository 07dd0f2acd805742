"""Resumable checkpointing with atomic publish and async save (mirror of
``repro/checkpoint/manager.py``), on one device or a mesh.

Layout per step, the JAX package's own, so one checkpoint feeds both
packages:

    <dir>/step_<k>/arrays.npz       flat {path: np.ndarray}, "/" stored
                                    as "\\x1f"
    <dir>/step_<k>/MANIFEST.json    written LAST -> atomic publish

Paths are the JAX package's ``tree_map_with_path_names`` names under
``params/`` and ``opt/`` (``opt/step``, ``opt/mu/<param path>``,
``opt/nu/...``, ``opt/master/...``), written in its order (dict keys
sorted at every level). The manifest carries the step, the time, the
caller's ``extra`` (the data loader's state) and each array's shape,
dtype and sha256; restore verifies the hashes.

bf16 leaves are written as the JAX package writes its ml_dtypes bf16
arrays: the raw 2-byte elements under the npy descr ``'<V2'`` (``np.load``
reads them as ``|V2``), ``"bfloat16"`` in the manifest, and read back as
``torch.bfloat16`` bit for bit. A 0-dim leaf (the int32 ``opt/step``)
stays 0-dim. Every npz member is byte for byte the JAX package's for the
same values.

Atomic publish: every file is written into ``<path>.tmp`` and fsync'd
(file contents and the tmp directory entry) before the ``rename``
publishes the step, and the parent directory is fsync'd after, so a crash
at any point of a save leaves either the complete new step or the
untouched previous one.

``save(..., blocking=False)`` copies every leaf to host memory before it
returns (the port's AdamW updates params and moments in place, and on the
CPU ``Tensor.numpy()`` would share their memory) and hashes and writes the
copy on a thread.

On a mesh (``CheckpointManager(mesh=)``, every rank calling ``save`` /
``wait`` / ``restore`` in the same order), ``save(shardings=,
opt_shardings=)`` gathers each leaf's full array from the ranks' blocks
(one collective step over every leaf) and rank 0 alone hashes and
writes it, in the same format; a barrier follows the publish (in
``wait`` for an async save). ``restore(shardings=, opt_shardings=)``
reads the full arrays and keeps this rank's block under the specs given,
for whatever mesh the restarted run has (the JAX package's elastic
re-shard).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import local_slice

MANIFEST = "MANIFEST.json"


def _fsync_path(path: str) -> None:
    """fsync a path by descriptor, directories included, so renames and
    new directory entries are durable, not just file bytes."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten_with_names(tree, prefix: str = "") -> Dict[str, object]:
    """{path: leaf} in the JAX package's flatten order: dict keys sorted
    at every level. A key may itself hold "/" (the optimizer moments are
    keyed by flattened param paths); it sorts as the nested path it
    names."""
    items = []
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            items.extend(_flatten_with_names(v, name).items())
        else:
            items.append((name, v))
    items.sort(key=lambda kv: kv[0].split("/"))
    return dict(items)


def _unflatten_like(like, flat: Dict[str, object], prefix: str = ""):
    return {k: (_unflatten_like(v, flat, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict)
                else flat[f"{prefix}/{k}" if prefix else str(k)])
            for k, v in like.items()}


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update reaches: bf16 as
    its raw 2-byte elements (``|V2``), everything else as its numpy
    dtype."""
    h = t.detach().to("cpu", copy=True).contiguous()
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.dtype("V2"))
    return h.numpy()


def _savez(f, host: dict, dtypes: dict) -> None:
    """``np.savez`` of ``host`` (uncompressed zip64 members, npy format
    1.0), with the bf16 members under the descr ml_dtypes gives them."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, v in host.items():
            with zf.open(k.replace("/", "\x1f") + ".npy", "w",
                         force_zip64=True) as fid:
                if dtypes[k] != "bfloat16":
                    np.lib.format.write_array(fid, v, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": v.shape})
                fid.write(np.ascontiguousarray(v).reshape(-1)
                          .view(np.uint8).data)


def _dtype_name(t: torch.Tensor, host: np.ndarray) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(host.dtype)


def _sha256(a: np.ndarray) -> str:
    """sha256 of the array's bytes (``a.tobytes()``), without copying."""
    return hashlib.sha256(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = np.asarray(a, order="C")  # keeps a 0-dim leaf 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


class CheckpointManager:
    """``save`` / ``restore`` of a (params, optimizer state) pair of dict
    trees of tensors, ``keep`` newest steps retained. ``saves`` records,
    per save: the step, bytes, the host snapshot's seconds (on the
    caller's thread) and the write's (hash, npz, fsyncs, publish; on the
    writer thread for an async save, filled in when it ends)."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # an async save not yet waited for
        self.saves: list = []

    # -- save ---------------------------------------------------------------
    def _full(self, flat: dict, specs: dict) -> dict:
        """The full arrays of this rank's blocks (a mesh's gather)."""
        mesh, out = self.mesh, {}
        for k, v in flat.items():
            for d, e in enumerate(specs[k]):
                if e is not None:
                    v = C.gather_nograd(v, d, mesh.group(e))
            out[k] = v
        return out

    def save(self, step: int, params, opt_state=None, extra: dict = None,
             blocking: bool = True, shardings=None, opt_shardings=None):
        """Snapshot to host memory synchronously, write asynchronously
        unless ``blocking``. On a mesh ``shardings`` ({path: spec}) and
        ``opt_shardings`` (the optimizer state's tree of specs) say how
        the blocks given make up each full array."""
        t0, wall = time.perf_counter(), time.time()
        tree = {"params": params}
        specs = {"params": shardings or {}}
        if opt_state is not None:
            tree["opt"] = opt_state
            specs["opt"] = opt_shardings or {}
        flat = _flatten_with_names(tree)
        if self.mesh is not None:
            flat = self._full(flat, _flatten_with_names(specs))
            if not self.writer:
                self.wait()
                if blocking:
                    C.barrier(self.mesh.group(self.mesh.axis_names))
                self._pending = not blocking
                return
        host, dtypes = {}, {}
        for k, v in flat.items():
            host[k] = _host_copy(v)
            dtypes[k] = _dtype_name(v, host[k])
        rec = {"step": step, "time": wall,
               "bytes": sum(a.nbytes for a in host.values()),
               "snapshot_s": time.perf_counter() - t0, "write_s": None,
               "blocking": blocking}
        self.wait()
        self.saves.append(rec)
        if blocking:
            self._write(step, host, dtypes, extra, rec)
            if self.mesh is not None:
                C.barrier(self.mesh.group(self.mesh.axis_names))
        else:
            self._thread = threading.Thread(
                target=self._write_async,
                args=(step, host, dtypes, extra, rec), daemon=True)
            self._thread.start()
            self._pending = True

    def _write_async(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def _write(self, step: int, host: dict, dtypes: dict, extra, rec: dict):
        t0 = time.perf_counter()
        meta = {
            "step": step,
            "time": rec["time"],
            "extra": extra or {},
            "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                           "sha256": _sha256(v)}
                       for k, v in host.items()},
        }
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            _savez(f, host, dtypes)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)      # the directory entries themselves
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)  # publish: atomic on POSIX
        _fsync_path(self.dir)  # make the rename durable
        self._gc()
        rec["write_s"] = time.perf_counter() - t0

    def wait(self):
        """Join the writer thread; re-raise what it raised. On a mesh, a
        barrier after an async save's publish."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and self._pending:
            C.barrier(self.mesh.group(self.mesh.axis_names))
        self._pending = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, MANIFEST)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_params, like_opt=None, step: Optional[int] = None,
                device=None, verify: bool = True, shardings=None,
                opt_shardings=None):
        """Returns (step, params, opt_state, extra). ``like_*`` give the
        tree structure; each leaf is placed on ``device``, or on the device
        of the like tree's first leaf. Leaves are read, verified and moved
        one at a time, so host memory holds one array at a time. On a
        mesh, ``shardings`` / ``opt_shardings`` (as in :meth:`save`, for
        the restarted run's mesh) cut each to this rank's block."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, MANIFEST)) as f:
            meta = json.load(f)
        arrays = meta["arrays"]

        def place(prefix, like, specs):
            names = _flatten_with_names(like)
            specs = _flatten_with_names(specs) if specs else {}
            dev = device if device is not None else \
                next(iter(names.values())).device
            flat = {}
            with np.load(os.path.join(path, "arrays.npz")) as npz:
                for n in names:
                    k = f"{prefix}/{n}"
                    a = npz[k.replace("/", "\x1f")]
                    if verify and _sha256(a) != arrays[k]["sha256"]:
                        raise IOError(f"checkpoint corruption at {k}")
                    if n in specs and self.mesh is not None:
                        a = local_slice(specs[n], self.mesh, self.mesh.rank,
                                        a)
                    flat[n] = _to_tensor(a, arrays[k]["dtype"], dev)
                    del a
            return _unflatten_like(like, flat)

        params = place("params", like_params, shardings)
        opt_state = None
        if like_opt is not None and any(k.startswith("opt/") for k in arrays):
            opt_state = place("opt", like_opt, opt_shardings)
        return step, params, opt_state, meta.get("extra", {})
