"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs as its own tests run it on the CPU (Pallas kernels in
interpret mode, ``Policy(compute_dtype=float32)``), the port runs the
plain versions of its kernels (CPU tensors).
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default thread pool oversubscribes them by ~50x."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(x):
    """jax array / torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_values_np(tree):
    """A JAX value tree (nested dicts) -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_values_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def split3(x):
    """The tensor-core kernels' split of f32 x (csrc/sm90.cuh split3):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded
    to nearest even; hi + mid + lo == x for 2^-110 <= |x| <
    (2 - 2^-8) 2^127 (tests/test_torch_gmm_dw.py holds it)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def ep_rank_worker(rank: int, world: int, init_file: str, in_path: str,
                   out_dir: str):
    """One EP rank of the two-rank zebra test (``torch.multiprocessing``
    target; imports no jax). Reads the cases of ``in_path`` (an npz of
    global inputs and a JSON list of cases), joins a gloo group through
    ``init_file``, runs ``zebra_spmd.make_ep_moe`` on its share and writes
    its output, aux losses and gradients to ``out_dir/<case>_<rank>.npz``.

    A rank's loss is its share of the global one: Σ y·ct over its rows
    (1/world of it in replicated mode, whose y is replicated) plus each
    aux loss times its cotangent over world (aux is replicated)."""
    import json

    import torch.distributed as dist

    from repro_torch.core import zebra_spmd as zs
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    data = np.load(in_path)
    aux_ct = json.loads(str(data["aux_ct"]))
    for case in json.loads(str(data["cases"])):
        zcfg = zs.ZebraConfig(**case["zcfg"])
        moe_fn = zs.make_ep_moe(cfg, run, zcfg, group=dist.group.WORLD)
        x, ct = data["x"], data["ct"]
        share = 1.0 / world
        if zcfg.mode == "alltoall":  # the batch is sharded over the ranks
            n = x.shape[0] // world
            x, ct = x[rank * n:(rank + 1) * n], ct[rank * n:(rank + 1) * n]
            share = 1.0
        p = {k: torch.from_numpy(data[k].copy()).requires_grad_(True)
             for k in ("router", "wi_gate", "wi_up", "wo")}
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y, aux = moe_fn(p, xt)
        loss = (y * torch.from_numpy(ct)).sum() * share + sum(
            aux[k] * c / world for k, c in aux_ct.items())
        loss.backward()
        np.savez(f"{out_dir}/{case['name']}_{rank}.npz", y=to_np(y),
                 dx=to_np(xt.grad),
                 **{f"aux_{k}": to_np(v) for k, v in aux.items()},
                 **{f"d_{k}": to_np(t.grad) for k, t in p.items()})
    dist.destroy_process_group()


def compress_rank_worker(rank: int, world: int, init_file: str, in_path: str,
                         out_dir: str):
    """One rank of the two-rank ``compressed_psum`` test
    (``torch.multiprocessing`` target; imports no jax): its share of the
    rows of ``grads`` and ``err`` in ``in_path`` through
    ``train.compression.compressed_psum`` over a gloo group joined through
    ``init_file``; writes the mean and its new error state to
    ``out_dir/psum_<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch.train import compression as comp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    data = np.load(in_path)
    n = data["grads"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    grads = {"w": torch.from_numpy(data["grads"][rows].copy())}
    err = {"w": torch.from_numpy(data["err"][rows].copy())}
    mean, new_err = comp.compressed_psum(grads, err, group=dist.group.WORLD)
    np.savez(f"{out_dir}/psum_{rank}.npz", mean=to_np(mean["w"]),
             err=to_np(new_err["w"]))
    dist.destroy_process_group()
