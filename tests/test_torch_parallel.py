"""The port's data axis over ``torch.distributed`` (``bin_tpu_torch/parallel``)
on the CPU: ``make_mesh`` and ``process_batch_slice`` against ``bin_tpu``'s
arithmetic, a spatial axis taken and a mesh that is not the world size
refused, and two gloo ranks started with the ``spawn`` context
(``tests/torch_dist_worker.py``, a timeout on every wait).  The ranks' rows
of a batch form the one-process batch, for the thread loader and the
worker loader; the two ranks' parameters after a train step are equal bit
for bit; against the one-process run on the same global batches the loss
is within rtol 1e-5 and the parameters within rtol 2e-4 and atol 2e-6 (the
bounds of ``tests/test_parallel.py``, bin_tpu's data-parallel step against
its single-device one); a run resumed from rank 0's checkpoint goes on as
the one-process run does; and the 2-rank ``evaluate_cli`` equals the
1-process one to the last bit.
"""

import json
import multiprocessing
import os
import queue
import socket
from unittest import mock

import numpy as np
import pytest
import torch

from bin_tpu.config import ParallelConfig as JaxParallelConfig
from bin_tpu.parallel import distributed as jax_distributed
from bin_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bin_tpu_torch.config import (ParallelConfig, apply_overrides,
                                  get_config, unported_training_fields)
from bin_tpu_torch.evaluation.evaluator import evaluate_cli
from bin_tpu_torch.parallel import (make_mesh, maybe_initialize,
                                    process_batch_slice)
from bin_tpu_torch.parallel import distributed, mesh
from bin_tpu_torch.training import trainer
from torch_dist_worker import EVAL, TINY, first_batches, params_of
from torch_params import one_torch_thread  # noqa: F401 (fixture)

WORLD = 2
TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def grad_enabled():
    """Grad mode on: ``tests/torch_twin.py`` turns it off at import, and
    the suite's workers import every test module."""
    with torch.enable_grad():
        yield


@pytest.mark.parametrize("global_batch,world,rank", [
    (8, 1, 0), (8, 2, 1), (8, 4, 3), (12, 4, 2), (6, 4, 1)])
def test_process_batch_slice_is_bin_tpus(global_batch, world, rank):
    with mock.patch.object(jax_distributed.jax, "process_count",
                           lambda: world), \
            mock.patch.object(jax_distributed.jax, "process_index",
                              lambda: rank):
        try:
            want = jax_distributed.process_batch_slice(global_batch)
        except ValueError as e:
            want = str(e)
    try:
        got = process_batch_slice(global_batch, rank, world)
    except ValueError as e:
        got = str(e)
    assert got == want
    with mock.patch.object(distributed, "world", lambda: (rank, world)):
        try:
            assert process_batch_slice(global_batch) == want
        except ValueError as e:
            assert str(e) == want


@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_mesh_resolves_the_data_axis_as_bin_tpu(world):
    import jax

    for size in (-1, world):
        want = jax_make_mesh(JaxParallelConfig(data_axis_size=size),
                             jax.devices()[:world])
        with mock.patch.object(mesh, "world", lambda: (world - 1, world)):
            plan = make_mesh(ParallelConfig(data_axis_size=size))
        assert (plan.num_data, plan.num_spatial) == (want.num_data,
                                                     want.num_spatial)
        assert plan.rank == world - 1 and plan.is_main == (world == 1)


def test_refusals_name_what_is_missing():
    # a spatial axis is taken: the world is data x spatial, bin_tpu's
    # devices.reshape(data, spatial)
    with mock.patch.object(mesh, "world", lambda: (3, 4)):
        plan = make_mesh(ParallelConfig(data_axis_size=-1,
                                        spatial_axis_size=2))
    assert (plan.num_data, plan.num_spatial) == (2, 2)
    assert (plan.data_index, plan.spatial_index) == (1, 1)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(ParallelConfig(spatial_axis_size=2))  # one process
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(ParallelConfig(data_axis_size=2))
    with mock.patch.object(mesh, "world", lambda: (0, 2)), \
            pytest.raises(ValueError, match="torchrun"):
        make_mesh(ParallelConfig(data_axis_size=1))
    assert get_config("config3_prf", ["parallel.spatial_axis_size=2"]) \
        .parallel.spatial_axis_size == 2
    cfg = get_config("config5_v5e_streaming",
                     ["parallel.spatial_axis_size=1"])
    assert cfg.parallel.data_axis_size == -1 and not (
        unported_training_fields(cfg))
    assert apply_overrides(cfg, ["parallel.data_axis_size=4"]).parallel \
        .data_axis_size == 4
    assert make_mesh(cfg.parallel).num_data == 1  # no launcher: one rank


def test_maybe_initialize_needs_a_launcher_or_an_address():
    for var in distributed._LAUNCHER_ENV:
        assert var not in os.environ or var == "LOCAL_RANK"
    assert maybe_initialize("cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.world() == (0, 1)
    assert str(distributed.local_device("cpu")) == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maybe_initialize("cuda", "tcp://localhost:1", 1, 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two spawned gloo ranks' results (``torch_dist_worker.run_rank``)."""
    from torch_dist_worker import run_rank

    workdir = str(tmp_path_factory.mktemp("dp_run"))
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=run_rank, args=(r, WORLD, port, workdir, out),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(WORLD):
            try:
                res = out.get(timeout=TIMEOUT_S)
            except queue.Empty:
                pytest.fail(f"a rank sent nothing in {TIMEOUT_S} s")
            assert "error" not in res, res.get("error")
            results[res["rank"]] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results, workdir


@pytest.fixture(scope="module")
def single(tmp_path_factory, ranks):
    """The one-process run of the same config: two steps straight."""
    workdir = str(tmp_path_factory.mktemp("one_process"))
    cfg = get_config("config3_prf", TINY)
    out = {}
    _, state = trainer.train(cfg, workdir, 1, device="cpu")
    out["step1"] = params_of(state)
    _, state = trainer.train(cfg, workdir, 2, device="cpu")
    out["step2"] = params_of(state)
    out["eval"] = evaluate_cli(get_config("config3_prf", [*TINY, *EVAL]),
                               device="cpu", verbose=False)
    return out, workdir


def _losses(workdir: str) -> list[float]:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss_total"] for line in f]


def test_ranks_rows_form_the_one_process_batch(ranks):
    results, _ = ranks
    assert [results[r]["plan"] for r in range(WORLD)] == [(2, 0), (2, 1)]
    whole = first_batches(None)
    for loader in ("thread", "worker"):
        for key in ("blurry", "sharp"):
            parts = [results[r]["batches"][loader][key] for r in range(WORLD)]
            assert all(p.shape[0] == 2 for p in parts)
            assert np.array_equal(np.concatenate(parts), whole[loader][key])
    # no rank reads (renders) another rank's rows
    assert whole["worker_reads"] == 4 and not whole["thread_sized_only"]
    for r in range(WORLD):
        assert results[r]["batches"]["worker_reads"] == 2
        assert results[r]["batches"]["thread_sized_only"]


@pytest.mark.parametrize("step", ["step1", "step2"])
def test_data_parallel_steps_equal_the_one_process_steps(ranks, single, step):
    """step2 is the run resumed from rank 0's checkpoint of step 1 (and its
    loader state) by both ranks."""
    results, workdir = ranks
    one, one_dir = single
    a, b = results[0][step], results[1][step]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for k in a:
        np.testing.assert_allclose(a[k], one[step][k], rtol=2e-4, atol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_losses(workdir), _losses(one_dir), rtol=1e-5)
    assert results[0]["files"] == results[1]["files"] == ["1.pt", "2.pt"]
    assert sorted(os.listdir(os.path.join(workdir, "checkpoints_loader"))) \
        == ["1.bin", "2.bin"]


def test_two_rank_eval_equals_the_one_process_eval(ranks, single):
    results, _ = ranks
    one, _ = single
    assert results[0]["eval"] == results[1]["eval"] == one["eval"]
    assert set(one["eval"]) >= {"psnr_overall", "ssim_overall"}


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_folder_sample_hw_is_the_sample_size(tmp_path, fmt):
    """``FrameFolderSource.sample_hw``, which the split thread loader reads
    for the rows it does not render, is the size of the sample."""
    from bin_tpu_torch.data.frames import FrameFolderSource, pil_image

    rng = np.random.default_rng(0)
    for kind, n in (("blurry", 5), ("sharp", 9)):
        d = tmp_path / kind / "clip0"
        d.mkdir(parents=True)
        for i in range(n):
            frame = rng.integers(0, 256, (24, 40, 3), np.uint8)
            if fmt == "npy":
                np.save(d / f"{i:06d}.npy", frame)
            else:
                pil_image().fromarray(frame).save(d / f"{i:06d}.png")
    for kw in ({"raw_u8": True}, {"resize_to": (16, 32)}):
        if fmt == "npy" and "resize_to" in kw:
            continue
        source = FrameFolderSource(str(tmp_path), num_keys=3, **kw)
        for i in range(len(source)):
            assert source.sample_hw(i) == source[i]["blurry"].shape[1:3]
