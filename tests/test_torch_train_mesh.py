"""The port's trainer over a mesh (`examples/train.py --dp / --tp /
--fsdp`) and `parallel/dryrun.py:dryrun_multichip` on gloo CPU ranks.

* `--device cpu --dp 2 --tp 2 --fsdp` at a tiny width: 2 steps on 4
  spawned ranks, from the tokens the single-rank run takes: every loss
  within 1e-5 of the single-rank `--device cpu` run's (fp32; the mesh sums
  in another order), every rank's parameters and AdamW moments 1 / dp of
  its TP shard's where FSDP cuts them;
* `--ckpt-dir` over the same mesh: 1 step saved, then a run to step 2 that
  resumes at step 1 and takes the uninterrupted run's second loss (1e-5);
  each rank's shard in its own `data<d>-model<m>/`; a restore under
  another mesh, and a single-rank restore of the mesh's directory, raise
  ValueError naming both meshes;
* `--moe 4` over `--dp 2`, and over `--dp 2 --tp 2 --fsdp` (expert
  parallelism): 2 steps whose losses are the single-rank `--moe 4` run's
  within 1e-5, since the routing's capacity, slots and aux loss are the
  whole batch's on every data rank;
* `dryrun_multichip(4)` prints JAX's `dryrun_multichip OK:` line, serving
  at JAX's head_dim 16, and without a device named it takes the card, so
  with none it raises.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from fa2_triton_tpu_torch.examples import train as ttrain  # noqa: E402
from fa2_triton_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from fa2_triton_tpu_torch.parallel.fsdp import train_specs  # noqa: E402
from fa2_triton_tpu_torch.utils.data import encode_corpus  # noqa: E402

BASE = ["--device", "cpu", "--dim", "64", "--layers", "2", "--seq", "17", "--batch", "4",
        "--lr", "1e-3"]
MESH = ["--dp", "2", "--tp", "2", "--fsdp"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus of 8 windows of 16 tokens (+ 1): a resumed run continues at
    the window an uninterrupted one takes."""
    path = str(tmp_path_factory.mktemp("corpus") / "corpus.bin")
    encode_corpus(np.random.RandomState(0).randint(0, 32000, size=1 + 8 * 16), path, 32000)
    return path


@pytest.fixture(scope="module")
def single(corpus):
    return {"random": ttrain.run(ttrain.parse_args(BASE + ["--steps", "2"])),
            "corpus": ttrain.run(ttrain.parse_args(BASE + ["--steps", "2", "--data", corpus])),
            "moe": ttrain.run(ttrain.parse_args(BASE + ["--steps", "2", "--moe", "4"]))}


def test_trainer_mesh_losses_equal_single_rank(single):
    res = ttrain.run(ttrain.parse_args(BASE + ["--steps", "2"] + MESH))
    np.testing.assert_allclose(res["losses"], single["random"]["losses"], rtol=0, atol=1e-5)
    assert res["report"].steps_skipped == 0 and res["backend"] == "gloo"
    ranks = res["ranks"]
    assert [r["coords"] for r in ranks] == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    # Each rank's bytes: every leaf over the axes its spec cuts (FSDP's data
    # 2 on top of TP 2), fp32; the two AdamW moments likewise.
    model = ttrain.init_params(torch.Generator().manual_seed(0),
                               ttrain.build_config(ttrain.parse_args(BASE)), device="cpu")
    specs = train_specs(model, {"data": 2, "model": 2}, fsdp=True)
    want = sum(4 * p.numel() // math.prod(2 for a in specs[n] if a)
               for n, p in model.named_parameters())
    assert any("data" in s for s in specs.values())
    for r in ranks:
        assert r["param_bytes"] == want and r["moment_bytes"] == 2 * want


@pytest.mark.parametrize("mesh", [["--dp", "2"], MESH], ids=["dp2", "dp2_tp2_fsdp"])
def test_trainer_moe_mesh_losses_equal_single_rank(single, mesh):
    res = ttrain.run(ttrain.parse_args(BASE + ["--steps", "2", "--moe", "4"] + mesh))
    assert len(res["ranks"]) == 2 * (2 if "--tp" in mesh else 1)
    np.testing.assert_allclose(res["losses"], single["moe"]["losses"], rtol=0, atol=1e-5)


def test_trainer_mesh_checkpoint_resume(single, corpus, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    data = ["--data", corpus]
    first = ttrain.run(ttrain.parse_args(BASE + ["--steps", "1", "--ckpt-dir", ckpt] + MESH
                                         + data))
    assert sorted(os.listdir(ckpt)) == ["data0-model0", "data0-model1", "data1-model0",
                                        "data1-model1", "mesh.json"]
    assert os.listdir(os.path.join(ckpt, "data1-model1")) == ["1.pt"]
    resumed = ttrain.run(ttrain.parse_args(BASE + ["--steps", "2", "--ckpt-dir", ckpt] + MESH
                                           + data))
    assert resumed["start"] == 1 and resumed["report"].resumed_from == 1
    np.testing.assert_allclose(first["losses"] + resumed["losses"], single["corpus"]["losses"],
                               rtol=0, atol=1e-5)
    for other in (["--dp", "4", "--fsdp"], []):
        with pytest.raises(ValueError, match="holds a checkpoint of mesh"):
            ttrain.run(ttrain.parse_args(BASE + ["--steps", "3", "--ckpt-dir", ckpt] + other))


def test_dryrun_multichip_prints_its_ok_line(capfd):
    res = dryrun_multichip(4, device="cpu")
    assert res["line"].startswith("dryrun_multichip OK: mesh=(data=2, model=2, seq=1)")
    assert "dryrun_multichip OK:" in capfd.readouterr().out
    assert res["ring_err"] < 2e-4 and res["pp_err"] < 1e-3
    assert abs(res["moe_loss"] - res["moe_ref"]) < 1e-4
    assert res["serve_head_dim"] == 16    # JAX's serving config; the caches pad it to 64


def test_dryrun_multichip_without_a_device_takes_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dryrun_multichip(4)
