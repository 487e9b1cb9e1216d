"""`dryrun_multichip(n)`: every mode of the parallel layer once, on n ranks
(the port's counterpart of `__graft_entry__.py:dryrun_multichip`).

    python -m fa2_triton_tpu_torch.parallel.dryrun 4 --device cpu
    python -m fa2_triton_tpu_torch.parallel.dryrun 4              # the card

JAX runs it as one program over n (virtual) devices; the port spawns n
ranks (`parallel/launch.py:spawn_ranks`) on the card by default (NCCL with
a card a rank, else gloo with CUDA tensors staged through host memory;
without a card it raises), or over gloo with CPU tensors where the caller
asks for `device="cpu"`, and each rank runs, at JAX's tiny shapes (fp32):

1. (data, model, seq) = JAX's factorisation of n, and one full training
   step (loss, gradients, AdamW) with TP attention (`parallel/fsdp.py`:
   Megatron over `model`, the batch over `data`);
2. ring attention forward and backward over `seq`, against one device's
   `flash_attn_func`;
3. a 2-stage GPipe forward (`parallel/pipeline.py`) against the
   sequential model;
4. an expert-parallel MoE step over `model` 2 (`models/moe.py:
   make_ep_mlp`), its loss against one device's;
5. TP serving over `model` max(tp, 2): the Engine's greedy tokens equal to
   one device's; and with 4 ranks or more a (data, model 2)
   `DataParallelEngine`'s, with work on every replica;
6. an FSDP / ZeRO-3 step over `data` min(n, 4) (`model` the rest), whose
   parameters stay 1 / dp a rank.

Rank 0 prints JAX's `dryrun_multichip OK: ...` line. n must be even (the
pipeline and the model-2 meshes take pairs of ranks).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

# JAX's factorisation of n into (data, model, seq).
FACTORS = {1: (1, 1, 1), 2: (2, 1, 1), 4: (2, 2, 1), 8: (2, 2, 2), 16: (2, 4, 2), 32: (4, 4, 2)}


def _tokens(seed: int, shape, vocab: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(0, vocab, size=shape)).to(device)


def _train_step(par, loss_fn, tokens, **kw) -> float:
    """One AdamW(1e-3) step of `par` (an FSDP) on this rank's rows."""
    opt = torch.optim.AdamW(par.model.parameters(), lr=1e-3)
    loss, grads = par.value_and_grad(loss_fn, tokens, **kw)
    for p, g in zip(par.params, grads):
        p.grad = g
    opt.step()
    return float(loss)


def dryrun_rank(rank: int, world: int, device=None) -> Dict:
    """The dry run on one rank of a joined world of `world` ranks, on the
    card unless `device` says otherwise (`utils.resolve_device`); returns
    its measurements (rank 0 prints the OK line)."""
    import torch.distributed as dist

    from fa2_triton_tpu_torch import flash_attn_func
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params, llama, moe
    from fa2_triton_tpu_torch.parallel import collectives as coll
    from fa2_triton_tpu_torch.parallel.fsdp import FSDP, train_specs
    from fa2_triton_tpu_torch.parallel.mesh import (
        AXIS_DATA, AXIS_MODEL, axis_group, make_mesh, shard_params,
    )
    from fa2_triton_tpu_torch.parallel.pipeline import (
        make_llama_pipeline_forward, pipeline_params_from_llama,
    )
    from fa2_triton_tpu_torch.parallel.ring import make_ring_attention
    from fa2_triton_tpu_torch.runtime.serving import DataParallelEngine, Engine
    from fa2_triton_tpu_torch.utils import resolve_device

    if world < 2 or world % 2:
        raise ValueError(f"dryrun_multichip takes an even number of ranks, got {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    dp, tp, sp = FACTORS.get(world, (world, 1, 1))
    mesh = make_mesh(data=dp, model=tp, seq=sp)

    # 1. One training step, TP attention over `model`, rows over `data`.
    cfg = LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4 * tp, n_kv_heads=2 * tp,
                      hidden_dim=128 * tp, max_seq_len=256, dtype=torch.float32)
    model = init_params(gen.manual_seed(0), cfg)
    B, S = 2 * dp, 256
    tokens = _tokens(1, (B, S), cfg.vocab_size, dev)
    par = FSDP(model, mesh, train_specs(model, mesh))
    d = par.coords[AXIS_DATA]
    loss = _train_step(par, llama.loss_fn, tokens[d * 2:(d + 1) * 2])
    assert np.isfinite(loss), f"non-finite loss {loss}"

    # 2. Ring attention forward and backward against one device.
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, 512, 4 * tp, 64), generator=g, device=dev)
    kv = q[:, :, :2 * tp].contiguous()
    do = torch.randn(q.shape, generator=g, device=dev)
    ring = make_ring_attention(mesh, causal=True)
    x = [t.clone().requires_grad_() for t in (q, kv, kv)]
    out = ring(*x)
    out.backward(do)
    x1 = [t.clone().requires_grad_() for t in (q, kv, kv)]
    out1 = flash_attn_func(*x1, causal=True)
    out1.backward(do)
    ring_err = max(float((a - b).detach().abs().max()) for a, b in
                   [(out, out1)] + [(t.grad, t1.grad) for t, t1 in zip(x, x1)])
    assert ring_err < 2e-4, f"ring bwd diverges from single-device: {ring_err}"

    # 3. A 2-stage pipeline forward against the sequential model.
    pipe_mesh = make_mesh(pipe=2, data=world // 2)
    pp_tokens = _tokens(4, (4, 64), cfg.vocab_size, dev)
    with torch.no_grad():
        pp_out = make_llama_pipeline_forward(pipe_mesh, cfg, n_microbatches=2)(
            pipeline_params_from_llama(model, pipe_mesh), pp_tokens)
        pp_err = float((pp_out - llama.forward(model, pp_tokens)).abs().max())
    assert pp_err < 1e-3, f"pipeline diverges from sequential: {pp_err}"

    # 4. Expert parallelism over `model` 2.
    ep_mesh = make_mesh(data=world // 2, model=2)
    moe_cfg = moe.MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=96, max_seq_len=64, dtype=torch.float32, n_experts=4,
                            top_k=2)
    moe_model = moe.init_params(gen.manual_seed(5), moe_cfg)
    moe_tokens = _tokens(6, (2, 33), moe_cfg.vocab_size, dev)
    local = shard_params(moe_model, ep_mesh, moe.moe_param_pspecs(moe_model))
    moe_l = moe.loss_fn(local, moe_tokens, mlp_fn=moe.make_ep_mlp(ep_mesh),
                        tp_group=axis_group(ep_mesh, AXIS_MODEL))
    moe_g = torch.autograd.grad(moe_l, list(local.parameters()))
    moe_l = moe_l.detach()
    assert np.isfinite(float(moe_l)), f"MoE EP loss non-finite: {float(moe_l)}"
    assert all(bool(t.isfinite().all()) for t in moe_g), "MoE EP grad NaN"
    with torch.no_grad():
        moe_ref = float(moe.loss_fn(moe_model, moe_tokens))
    assert abs(float(moe_l) - moe_ref) < 1e-4, (float(moe_l), moe_ref)

    # 5. TP serving (and data-parallel serving) against one device, at JAX's
    # config (head_dim 16 = dim / heads; the caches hold it padded to 64).
    cfg_serve = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            hidden_dim=128, max_seq_len=128, dtype=torch.float32)
    params_serve = init_params(gen.manual_seed(3), cfg_serve)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    m_serve = max(tp, 2)
    serve_mesh = make_mesh(data=world // m_serve, model=m_serve)

    def generate(engine, reqs_of):
        reqs = [engine.submit(p, 6) for p in reqs_of]
        engine.run()
        return [list(r.out_tokens) for r in reqs]

    with torch.inference_mode():
        toks_tp = generate(Engine(params_serve, cfg_serve, n_slots=2, max_seq=128,
                                  mesh=serve_mesh[AXIS_MODEL]), prompts)
        toks_1dev = generate(Engine(params_serve, cfg_serve, n_slots=2, max_seq=128), prompts)
        assert toks_tp == toks_1dev, f"TP serving tokens diverge: {toks_tp} vs {toks_1dev}"
        dp_note = "DP serving needs 4 ranks"
        if world >= 4:
            dp_mesh = make_mesh(data=world // 2, model=2)
            dp_prompts = [prompts[i % 2] for i in range(max(2, world // 2))]
            dp_eng = DataParallelEngine(params_serve, cfg_serve, dp_mesh, n_slots=1, max_seq=128)
            dp_toks = generate(dp_eng, dp_prompts)
            ref = generate(Engine(params_serve, cfg_serve, n_slots=2, max_seq=128), dp_prompts)
            assert dp_toks == ref, f"DP serving tokens diverge: {dp_toks} vs {ref}"
            busy = coll.all_gather_ints([dp_eng.engine.stats.decode_tokens], dp_eng.data_group)
            assert all(b[0] > 0 for b in busy), "DP serving left a replica idle"
            dp_note = f"DP({world // 2}x2) serving tokens == single-device"

    # 6. FSDP / ZeRO-3 over `data`.
    nf = min(world, 4)
    fsdp_mesh = make_mesh(data=nf, model=world // nf)
    cfg_f = LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                        hidden_dim=128, max_seq_len=128, dtype=torch.float32)
    model_f = init_params(gen.manual_seed(0), cfg_f)
    par_f = FSDP(model_f, fsdp_mesh, train_specs(model_f, fsdp_mesh, fsdp=True))
    toks_f = _tokens(8, (4, 128), cfg_f.vocab_size, dev)
    rows, df = 4 // nf, par_f.coords[AXIS_DATA]
    loss_f = _train_step(par_f, llama.loss_fn, toks_f[df * rows:(df + 1) * rows])
    assert np.isfinite(loss_f), f"FSDP loss non-finite: {loss_f}"
    # The updated parameters stay cut (1 / dp of the embedding a rank).
    assert par_f.model.embed.numel() * nf == model_f.embed.numel(), \
        "FSDP step returned replicated params"

    line = (f"dryrun_multichip OK: mesh=(data={dp}, model={tp}, seq={sp}), train loss={loss:.4f}, "
            f"ring fwd+bwd max|Δ|={ring_err:.2e}, pipeline(2-stage) max|Δ|={pp_err:.2e}, "
            f"MoE EP loss={float(moe_l):.4f}, TP={m_serve} serving tokens == single-device "
            f"({sum(len(t) for t in toks_tp)} tokens), {dp_note}, FSDP(data={nf}) step "
            f"loss={loss_f:.4f}")
    if rank == 0:
        print(line, flush=True)
    dist.barrier()
    return {"line": line, "train_loss": loss, "ring_err": ring_err, "pp_err": pp_err,
            "moe_loss": float(moe_l), "moe_ref": moe_ref, "fsdp_loss": loss_f,
            "serve_head_dim": cfg_serve.hd}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0) -> Dict:
    """Run the dry run on `n_devices` spawned ranks: on the card by default
    (NCCL with a card a rank, else gloo with host staging; without a card
    it raises), on gloo CPU ranks with `device="cpu"`. Returns rank 0's
    measurements; a failed rank raises."""
    from fa2_triton_tpu_torch.parallel.launch import spawn_ranks
    from fa2_triton_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda') but no CUDA device is visible")
        if torch.cuda.device_count() >= n_devices:
            backend = "nccl"
    return spawn_ranks(_rank, n_devices, (dev.type,), backend=backend, timeout_s=timeout_s)[0]


def _rank(rank: int, world: int, device: str) -> Dict:
    if device == "cpu":
        torch.set_num_threads(1)
    return dryrun_rank(rank, world, device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the parallel layer's dry run on n ranks")
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
