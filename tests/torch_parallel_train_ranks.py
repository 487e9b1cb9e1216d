"""Rank functions of the port's parallel-training tests
(`test_torch_pipeline.py`, `test_torch_parallel_train.py`). A spawned rank
imports this module by name, so it holds only what a rank needs: torch and
the port, never JAX (each rank checks that). Weights come in as the JAX
tree converted to numpy by the test; results go back as numpy arrays and
plain values, every rank's, so the test assembles the pieces."""
import sys

import torch


def _no_jax():
    bad = [n for n in sys.modules if n == "jax" or n.startswith(("jax.", "fa2_triton_tpu."))]
    assert not bad, bad


def _model(tree, cfg_kw, moe=False):
    from fa2_triton_tpu_torch.models import LlamaConfig, MoEConfig
    from fa2_triton_tpu_torch.models.convert import llama_from_jax_params

    cfg = (MoEConfig if moe else LlamaConfig)(dtype=torch.float32, **cfg_kw)
    return llama_from_jax_params(tree, cfg, device="cpu")


def _grads(model):
    return {n: (p.grad.numpy().copy() if p.grad is not None else None)
            for n, p in model.named_parameters()}


def _np(t):
    return t.detach().numpy().copy()


# -- pipelines -----------------------------------------------------------------

def pipeline_case(case):
    """One pipeline case on this rank of an 8-rank world. Kinds: "generic"
    (tanh layers, ys), "llama" (logits), "llama_grad" (CE loss over the
    pipeline's logits, its value and the model's gradients), "3d" (logits,
    and the gradients of mean(log_softmax(logits) ** 2))."""
    import torch.nn.functional as F

    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.parallel import pipeline as pl

    mesh = make_mesh(**case["mesh"])
    if case["kind"] == "generic":
        layers = [{"w": torch.from_numpy(w)} for w in case["ws"]]
        local = pl.shard_stacked_layers(pl.stack_layer_params(layers), mesh)

        def stage_fn(local, x):
            for w in local["w"]:
                x = torch.tanh(x @ w)
            return x

        ys = pl.make_pipeline(mesh, stage_fn, case["M"])(local, torch.from_numpy(case["xs"]))
        return {"ys": _np(ys)}
    model = _model(case["tree"], case["cfg"])
    tokens = torch.from_numpy(case["tokens"]).long()
    if case["kind"] == "3d":
        fwd = pl.make_llama_3d_forward(mesh, model.cfg, case["M"])
        logits = fwd(pl.pipeline_params_from_llama(model, mesh, tp=True), tokens)
        (torch.log_softmax(logits, -1) ** 2).mean().backward()
        return {"logits": _np(logits), "grads": _grads(model)}
    fwd = pl.make_llama_pipeline_forward(mesh, model.cfg, case["M"])
    pp = pl.pipeline_params_from_llama(model, mesh)
    if case["kind"] == "llama":
        with torch.no_grad():
            return {"logits": _np(fwd(pp, tokens))}
    logits = fwd(pp, tokens[:, :-1])
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    loss.backward()
    return {"loss": float(loss), "grads": _grads(model)}


def pipeline_rank(rank, world, cases):
    torch.set_num_threads(1)
    out = [pipeline_case(c) for c in cases]
    _no_jax()
    return out


# -- TP / FSDP / EP training and the guard ---------------------------------------

def _local_grads(par, grads):
    return {n: g.numpy().copy() for n, g in zip(par.names, grads)}


def train_case(case):
    """One training case on this rank of a 4-rank world; returns this
    rank's coordinates, specs and pieces. Kinds: "tp" (loss and gradients
    of loss_fn over `FSDP` with no data cut), "fsdp" (one AdamW(1e-3) step:
    the loss, the updated pieces, the bytes of pieces and moments), "ep_mlp"
    (the EP block's out and aux), "ep_train" (moe.loss_fn with EP and TP
    attention: loss and gradient pieces), "moe_dp" (the trainer's MoE loss,
    `examples/train.py:model_loss`, on this data rank's rows: loss and
    gradient pieces, and the loss of routing each rank's rows alone),
    "guard" (a NaN on data rank 1 only, then a clipped step's global norm
    against one rank's)."""
    import functools

    from fa2_triton_tpu_torch.models import llama, moe
    from fa2_triton_tpu_torch.parallel import collectives as coll
    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.parallel.fsdp import FSDP, train_specs
    from fa2_triton_tpu_torch.parallel.mesh import AXIS_MODEL, axis_group, axis_rank, shard_params

    mesh = make_mesh(**case["mesh"])
    kind = case["kind"]
    tokens = torch.from_numpy(case["tokens"]).long() if "tokens" in case else None
    if kind == "ep_mlp":
        model = _model(case["tree"], case["cfg"], moe=True)
        # The block alone: only the experts are cut (JAX's shard_map).
        specs = {n: s for n, s in moe.moe_param_pspecs(model).items() if ".we_" in n}
        local = shard_params(model, mesh, specs)
        out, aux = moe.make_ep_mlp(mesh)(local.layers[0], torch.from_numpy(case["x"]), local.cfg)
        return {"out": _np(out), "aux": float(aux)}
    if kind == "ep_train":
        model = _model(case["tree"], case["cfg"], moe=True)
        specs = moe.moe_param_pspecs(model)
        local = shard_params(model, mesh, specs)
        loss = moe.loss_fn(local, tokens, mlp_fn=moe.make_ep_mlp(mesh),
                           tp_group=axis_group(mesh, AXIS_MODEL))
        loss.backward()
        return {"loss": float(loss), "grads": _grads(local), "specs": specs,
                "model": axis_rank(mesh, AXIS_MODEL)}
    model = _model(case["tree"], case["cfg"], moe=kind == "moe_dp")
    par = FSDP(model, mesh, train_specs(model, mesh, fsdp=kind in ("fsdp", "guard")
                                        or case.get("fsdp", False), moe=kind == "moe_dp"))
    d = par.coords["data"]
    if case.get("rows"):          # this data rank's rows of the global batch
        b = tokens.shape[0] // par.dp
        tokens = tokens[d * b:(d + 1) * b]
    base = {"coords": dict(par.coords), "specs": par.specs}
    if kind == "tp":
        loss, grads = par.value_and_grad(llama.loss_fn, tokens)
        return {**base, "loss": float(loss), "grads": _local_grads(par, grads)}
    if kind == "moe_dp":
        from fa2_triton_tpu_torch.examples.train import model_loss

        loss, grads = par.value_and_grad(model_loss(model.cfg, par), tokens)
        alone = moe.make_ep_mlp(mesh) if par.tp > 1 else moe.moe_mlp
        with torch.no_grad():
            rank_alone = coll.all_reduce(par.loss(functools.partial(moe.loss_fn, mlp_fn=alone),
                                                  tokens), par.data_group) / par.dp
        return {**base, "loss": float(loss), "grads": _local_grads(par, grads),
                "rank_alone": float(rank_alone)}
    opt = torch.optim.AdamW(par.model.parameters(), lr=1e-3, weight_decay=1e-4)
    if kind == "fsdp":
        loss, grads = par.value_and_grad(llama.loss_fn, tokens)
        for p, g in zip(par.params, grads):
            p.grad = g
        opt.step()
        moments = {n: [int(t.numel()) for k, t in opt.state[p].items() if k != "step"]
                   for n, p in zip(par.names, par.params)}
        return {**base, "loss": float(loss), "moments": moments,
                "params": {n: _np(p) for n, p in zip(par.names, par.params)}}
    # "guard": the guarded step over the mesh, rank 1 of `data` poisoned.
    import torch.distributed as dist

    from fa2_triton_tpu_torch.examples.train import step_fns
    from fa2_triton_tpu_torch.utils.resilience import ResilientTrainer

    state = {"model": par.model, "opt": opt, "step": 0}
    grad_fn, apply_fn = step_fns(model.cfg, lambda s: 1e-3, 1.0, par=par)

    def poisoned(state, batch):
        loss, grads = grad_fn(state, batch)
        if d == 1:
            grads = [g * float("nan") if i == 0 else g for i, g in enumerate(grads)]
        return loss, grads

    before = {k: v.clone() for k, v in par.model.state_dict().items()}
    trainer = ResilientTrainer(poisoned, apply_fn, None, group=dist.group.WORLD)
    _, ok = trainer.step(state, tokens, 0)
    after = par.model.state_dict()
    unchanged = all(torch.equal(before[k], after[k]) for k in before) and not opt.state \
        and state["step"] == 0
    # A clipped step's global norm against the single-rank norm of the same
    # batch's gradient (this rank computes that whole model's too).
    _, grads = par.value_and_grad(llama.loss_fn, tokens)
    norm = float(par.grad_norm(grads))
    ref = llama.loss_fn(model, torch.from_numpy(case["tokens"]).long())
    ref.backward()
    ref_norm = float(torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0))
    trainer2 = ResilientTrainer(grad_fn, apply_fn, None, group=dist.group.WORLD)
    _, ok2 = trainer2.step(state, tokens, 0)
    return {**base, "ok": ok, "unchanged": bool(unchanged), "skipped": trainer.report.steps_skipped,
            "norm": norm, "ref_norm": ref_norm, "ok2": ok2, "step": state["step"]}


def train_rank(rank, world, cases):
    torch.set_num_threads(1)
    out = [train_case(c) for c in cases]
    _no_jax()
    return out
