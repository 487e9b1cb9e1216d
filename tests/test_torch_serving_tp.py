"""Tensor-parallel and data-parallel serving of the port
(`Engine(mesh=...)`, `DataParallelEngine`, `serving_demo --tp`) against the
JAX package on the CPU, at JAX's `tests/test_serving_tp.py` config and
prompts (fp32, vocab 256, dim 64, 2 layers, 4 / 2 heads).

The port's runs go through spawned gloo CPU ranks (a world of 2 for the TP
Engine, 4 for data 2 x model 2), once for the module, while the JAX engines
run. The dense case (with one sampled request) is held against JAX's own TP
Engine on its virtual mesh, the others against JAX's single-device Engine,
and the data-parallel engine against JAX's `DataParallelEngine`, request by
request, with the replica JAX's dispatch chose for each: tokens equal,
log-probs within 1e-4."""
import concurrent.futures
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fa2_triton_tpu.models import llama as jl  # noqa: E402
from fa2_triton_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from fa2_triton_tpu.runtime import serving as js  # noqa: E402
from fa2_triton_tpu.runtime.sampling import SamplingParams as JaxSampling  # noqa: E402
from fa2_triton_tpu_torch.models import LlamaConfig  # noqa: E402
from fa2_triton_tpu_torch.models.convert import llama_from_jax_params  # noqa: E402
from fa2_triton_tpu_torch.parallel import spawn_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_ranks as tpr  # noqa: E402

KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
          max_seq_len=256)
J_CFG = jl.LlamaConfig(dtype=jnp.float32, **KW)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [20] * 40]
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=3)
PREFIX_PROMPT = np.random.RandomState(9).randint(0, 256, size=150).tolist()
LP_TOL = 1e-4
# name: (Engine options, prompts, sampling per prompt, new tokens, JAX's
# reference: "tp" = JAX's TP Engine, "single" = its single-device Engine).
RUNS = {
    "dense_and_sampled": ({}, PROMPTS + [[3, 1, 4]], [None] * 3 + [SAMPLED], 10, "tp"),
    "paged": ({"paged": True}, PROMPTS, None, 10, "single"),
    "int8_kv": ({"qdtype": "int8"}, PROMPTS, None, 10, "single"),
    "int8_weights": ({}, PROMPTS, None, 10, "single"),
    "prefix_cache": ({"paged": True, "page_size": 128, "prefix_cache": True},
                     [PREFIX_PROMPT, PREFIX_PROMPT], None, 6, "single"),
}


def _port_runs(weights):
    """The port's TP runs (world 2) and its data-parallel run (world 4),
    each world spawned once."""
    runs = []
    for name, (engine, prompts, sampling, new, _) in RUNS.items():
        runs.append(dict(cfg=KW, weights=weights, quantize=name == "int8_weights",
                         engine=dict(n_slots=4 if name != "prefix_cache" else 2, max_seq=256,
                                     **engine),
                         prompts=prompts, sampling=sampling or [None] * len(prompts), new=new))
    tp = spawn_ranks(tpr.serve_rank, 2, (runs,), timeout_s=300)
    dp_run = dict(cfg=KW, weights=weights, engine=dict(n_slots=2, max_seq=256),
                  dp={"data": 2, "model": 2}, prompts=PROMPTS, new=10)
    dp = spawn_ranks(tpr.serve_rank, 4, ([dp_run],), timeout_s=300)
    return {"tp": dict(zip(RUNS, zip(*tp))), "dp": [r[0] for r in dp]}


def _jax_engine(params, name):
    engine, prompts, sampling, new, how = RUNS[name]
    kw = {k: (jnp.int8 if k == "qdtype" else v) for k, v in engine.items()}
    if name == "prefix_cache":
        kw["prefix_cache"] = False      # the cold engine: every prompt prefilled whole
    mesh = jax_mesh(model=2, devices=jax.devices()[:2]) if how == "tp" else None
    p = jl.quantize_model_params(params) if name == "int8_weights" else params
    eng = js.Engine(p, J_CFG, n_slots=4 if name != "prefix_cache" else 2, max_seq=256, mesh=mesh,
                    **kw)
    reqs = [eng.submit(pr, new, sampling=JaxSampling(**s) if s else None)
            for pr, s in zip(prompts, sampling or [None] * len(prompts))]
    eng.run()
    return [r.out_tokens for r in reqs], [r.out_logprobs for r in reqs]


def _jax_dp(params):
    """JAX's DataParallelEngine, with the replica its dispatch hands each
    request to (recorded on the replicas' queues)."""
    dp = js.DataParallelEngine(params, J_CFG, jax_mesh(data=2, model=2, devices=jax.devices()[:4]),
                               n_slots=2, max_seq=256)
    chosen = {}

    class Recorded(list):
        def __init__(self, i):
            super().__init__()
            self.i = i

        def append(self, req):
            chosen[req.rid] = self.i
            super().append(req)

    for i, e in enumerate(dp.engines):
        e.queue = Recorded(i)
    reqs = [dp.submit(p, 10) for p in PROMPTS]
    dp.run()
    return ([r.out_tokens for r in reqs], [r.out_logprobs for r in reqs], chosen,
            [e.stats.decode_tokens for e in dp.engines])


@pytest.fixture(scope="module")
def results():
    params = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    model = llama_from_jax_params(jax.tree.map(np.asarray, params),
                                  LlamaConfig(dtype=torch.float32, **KW), device="cpu")
    weights = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, weights)
        refs = {name: _jax_engine(params, name) for name in RUNS}
        refs["dp"] = _jax_dp(params)
        return port.result(), refs


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_engine_matches_jax(results, name):
    """Both ranks of the TP Engine serve JAX's tokens, log-probs within
    1e-4; the prefix-cache engine hits one full page of the repeated
    prompt."""
    port, refs = results
    tokens, lps = refs[name]
    for rank_res in port["tp"][name]:
        assert rank_res["done"]
        assert rank_res["tokens"] == tokens
        for got, want in zip(rank_res["logprobs"], lps):
            assert np.abs(np.array(got) - np.array(want)).max() < LP_TOL
    if name == "prefix_cache":
        assert all(r["cached"] == 128 for r in port["tp"][name])


def test_data_parallel_engine_matches_jax(results):
    """data 2 x model 2: every rank returns JAX's DataParallelEngine's tokens,
    each request served by the replica JAX's max(free) dispatch picks (ties
    to the highest index), and both replicas decode."""
    port, refs = results
    tokens, lps, chosen, _ = refs["dp"]
    for rank_res in port["dp"]:
        assert rank_res["done"] and rank_res["tokens"] == tokens
        assert rank_res["replica_of"] == chosen
        for got, want in zip(rank_res["logprobs"], lps):
            assert np.abs(np.array(got) - np.array(want)).max() < LP_TOL
    decoded = {}
    for rank, rank_res in enumerate(port["dp"]):
        decoded.setdefault(rank // 2, set()).add(rank_res["decode_tokens"])
    assert all(len(v) == 1 and min(v) > 0 for v in decoded.values()), decoded


def test_serving_demo_tp_2_serves_on_two_ranks(capsys):
    """`serving_demo --tp 2` on the CPU: two gloo ranks serve one TP Engine
    and rank 0's JSON line is printed."""
    from fa2_triton_tpu_torch.runtime import serving_demo

    res = serving_demo.main(["--device", "cpu", "--dim", "64", "--layers", "1", "--heads", "4",
                             "--kv-heads", "2", "--slots", "2", "--max-seq", "256",
                             "--requests", "3", "--prompt-len", "16", "--new-tokens", "3",
                             "--tp", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serving_decode_tokens_per_s_tp2" and line["value"] > 0
    assert res["stats"].decode_tokens == 3 * (3 - 1)
