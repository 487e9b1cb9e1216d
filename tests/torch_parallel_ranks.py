"""Rank functions of the port's parallel-layer tests
(`test_torch_parallel_attention.py`, `test_torch_serving_tp.py`,
`test_torch_mesh.py`, the `cuda` tests). A spawned rank imports this module
by name, so it holds only what a rank needs: torch and the port, never JAX
(each rank checks that). Every function runs all of its file's cases in one
world and returns numpy arrays and plain Python values."""
import sys

import numpy as np
import torch


def _no_jax():
    bad = [n for n in sys.modules if n == "jax" or n.startswith(("jax.", "fa2_triton_tpu."))]
    assert not bad, bad


def attention_inputs(B, S, Hq, Hkv, D, seed, device="cpu"):
    """q, k, v [B, S, H, D], do [B, S, Hq, D], dlse [B, Hq, S] fp32 from
    numpy.random.RandomState(seed)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    do = rs.randn(B, S, Hq, D).astype(np.float32)
    dlse = rs.randn(B, Hq, S).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (q, k, v, do, dlse)]


def run_attention_case(case, device="cpu"):
    """One parallel attention case on this rank: forward + backward of the
    mesh's function on the case's global inputs, the loss sum(out * do)
    (+ sum(lse * dlse) with `lse`). Returns {"out", "lse", "dq", "dk", "dv"}
    as numpy (lse None without it). `case` keys: kind ("ring", "ulysses",
    "tp"), mesh ({axis: size}), shape (B, S, Hq, Hkv, D), seed, and the
    function's keywords under kw; `rng` (a seed) passes a CPU generator as
    dropout_rng, `dtype` the input dtype."""
    from fa2_triton_tpu_torch.parallel import (
        make_mesh, make_ring_attention, make_tp_attention, make_ulysses_attention,
    )

    mesh = make_mesh(**case["mesh"])
    q, k, v, do, dlse = attention_inputs(*case["shape"], case["seed"], device)
    dt = getattr(torch, case.get("dtype", "float32"))
    x = [t.to(dt).requires_grad_() for t in (q, k, v)]
    kw = dict(case.get("kw", {}))
    if case["kind"] == "ring":
        fn = make_ring_attention(mesh, return_lse=True, **kw)
        call = {"dropout_rng": torch.Generator().manual_seed(case["rng"])} if "rng" in case else {}
        out, lse = fn(*x, **call)
    else:
        make = make_ulysses_attention if case["kind"] == "ulysses" else make_tp_attention
        out, lse = make(mesh, **kw)(*x), None
    loss = (out.float() * do).sum()
    if case.get("lse"):
        loss = loss + (lse * dlse).sum()
    loss.backward()
    res = {"out": out.detach().float().cpu().numpy(),
           "lse": lse.detach().cpu().numpy() if lse is not None else None}
    res.update({n: t.grad.float().cpu().numpy() for n, t in zip(("dq", "dk", "dv"), x)})
    return res


def attention_cases_rank(rank, world, cases, device="cpu"):
    """Every case of `cases` in one world (the ranks run them in order);
    rank 0's results (every rank gathers the whole out and gradients)."""
    torch.set_num_threads(1)
    out = [run_attention_case(c, device) for c in cases]
    _no_jax()
    return out if rank == 0 else None


def mesh_rank(rank, world, shapes):
    """The mesh of each of `shapes` ({axis: size}, or {"multihost": (model,
    seq, ranks a host)}) on this rank: its layout, axis names, this rank's
    place and its group's members per axis."""
    import torch.distributed as dist

    from fa2_triton_tpu_torch.parallel.mesh import make_mesh, make_multihost_mesh

    out = []
    for shape in shapes:
        if "multihost" in shape:
            model, seq, local = shape["multihost"]
            mesh = make_multihost_mesh(model=model, seq=seq, local_world=local)
        else:
            mesh = make_mesh(**shape)
        names = mesh.mesh_dim_names
        out.append({"layout": mesh.mesh.numpy(), "names": names,
                    "coords": {n: mesh.get_local_rank(n) for n in names},
                    "groups": {n: dist.get_process_group_ranks(mesh.get_group(n))
                               for n in names}})
    _no_jax()
    return out


def serve_rank(rank, world, runs):
    """Each run of `runs` on this rank: a tiny LLaMA built from the numpy
    weights given (`weights`: {name: array}, the JAX model's, converted by
    the test), served through `Engine(mesh=make_mesh(model=world))` or a
    `DataParallelEngine` over make_mesh(data=..., model=...). Returns per
    run the tokens, log-probs, this rank's engine's prefix-cached and
    decoded tokens, and the replica choices."""
    from fa2_triton_tpu_torch.models import LlamaConfig
    from fa2_triton_tpu_torch.models.llama import LlamaModel, quantize_model_params
    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.runtime import DataParallelEngine, Engine, SamplingParams

    torch.set_num_threads(1)
    outs = []
    models = {}
    for run in runs:
        cfg = LlamaConfig(dtype=torch.float32, **run["cfg"])
        key = (tuple(sorted(run["cfg"].items())), run.get("quantize", False))
        if key not in models:
            model = LlamaModel(cfg, device="cpu")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.from_numpy(run["weights"][name]))
            models[key] = quantize_model_params(model) if run.get("quantize") else model
        model = models[key]
        kw = dict(run.get("engine", {}))
        if "qdtype" in kw:
            kw["qdtype"] = getattr(torch, kw["qdtype"])
        if run.get("dp"):
            eng = DataParallelEngine(model, cfg, make_mesh(**run["dp"]), **kw)
        else:
            eng = Engine(model, cfg, mesh=make_mesh(model=world), **kw)
        reqs = [eng.submit(p, run["new"], sampling=SamplingParams(**s) if s else None)
                for p, s in zip(run["prompts"], run.get("sampling", [None] * len(run["prompts"])))]
        eng.run()
        stats = eng.engine.stats if run.get("dp") else eng.stats
        outs.append({"tokens": [list(r.out_tokens) for r in reqs],
                     "logprobs": [list(r.out_logprobs) for r in reqs],
                     "done": all(r.done for r in reqs),
                     "cached": stats.prefix_cached_tokens,
                     "replica_of": dict(getattr(eng, "replica_of", {})),
                     "decode_tokens": stats.decode_tokens})
    _no_jax()
    return outs
