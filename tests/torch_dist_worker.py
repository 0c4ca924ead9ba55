"""One rank of the port's data-parallel CPU runs
(``tests/test_torch_parallel.py``).

``run_rank`` joins a gloo group on ``tcp://localhost:<port>`` and runs, in
this order: the first batch of each loader for this rank's rows, a train
run of one step through ``training.trainer.train`` on a shared workdir,
the same run resumed from rank 0's checkpoint to two steps, and
``evaluate_cli``; it puts the results on ``out``.  The module imports no
JAX, so a spawned rank starts in seconds.
"""

from __future__ import annotations

import os
import traceback

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16", "data.crop_size=32,32",
        "data.batch_size=4", "data.seq_len=5", "data.loader=grain",
        "parallel.data_axis_size=-1", "log.log_interval_steps=1"]
EVAL = ["data.eval_size=32,32", "data.eval_num_keys=6",
        "data.eval_num_clips=3"]


def first_batches(rows):
    """The first batch of the thread loader and of the worker loader (in
    process) over a tiny synthetic source, for ``rows`` of the batch; with
    how many samples the worker loader read for it, and whether the thread
    loader drew the other rows' crops from their sizes alone (it reads
    ahead on its thread, so its reads are not counted)."""
    from bin_tpu_torch.data.loader import WorkerLoader
    from bin_tpu_torch.data.pipeline import SyntheticSource, train_iterator

    class Counted(SyntheticSource):
        reads = sizes = 0

        def __getitem__(self, i):
            Counted.reads += 1
            return super().__getitem__(i)

        def sample_hw(self, i):
            Counted.sizes += 1
            return super().sample_hw(i)

    source = Counted(6, 5, 40, 40, seed=2, as_u8=True)
    it = train_iterator(source, 4, (32, 32), seed=1, rows=rows, keep_u8=True)
    out = {"thread": next(it)}
    it.close()
    out["thread_sized_only"] = Counted.sizes > 0
    Counted.reads = 0
    with WorkerLoader(source, 4, (32, 32), seed=1, keep_u8=True,
                      rows=rows) as loader:
        out.update(worker=next(loader), worker_reads=Counted.reads)
    return out


def params_of(state) -> dict:
    """The parameters as numpy arrays (a tensor on a queue would be shared
    through a file descriptor that dies with its process)."""
    return {k: v.detach().numpy().copy()
            for k, v in state.named(state.params).items()}


def run_rank(rank: int, world: int, port: int, workdir: str, out) -> None:
    try:
        import torch

        torch.set_num_threads(1)
        from bin_tpu_torch.config import get_config
        from bin_tpu_torch.evaluation.evaluator import evaluate_cli
        from bin_tpu_torch.parallel import (make_mesh, maybe_initialize,
                                            process_batch_slice)
        from bin_tpu_torch.training import trainer

        assert maybe_initialize("cpu", f"tcp://localhost:{port}", world, rank)
        cfg = get_config("config3_prf", TINY)
        per, start = process_batch_slice(cfg.data.batch_size)
        plan = make_mesh(cfg.parallel)
        result = {"rank": rank, "plan": (plan.num_data, plan.rank),
                  "batches": first_batches((start, per))}
        _, state = trainer.train(cfg, workdir, 1, device="cpu")
        result["step1"] = params_of(state)
        _, state = trainer.train(cfg, workdir, 2, device="cpu")
        result["step2"] = params_of(state)
        result["files"] = sorted(os.listdir(os.path.join(workdir,
                                                         "checkpoints")))
        result["eval"] = evaluate_cli(get_config("config3_prf",
                                                 [*TINY, *EVAL]),
                                      device="cpu", verbose=False)
        out.put(result)
    except BaseException:
        out.put({"rank": rank, "error": traceback.format_exc()})
    finally:
        from bin_tpu_torch.parallel.distributed import shutdown

        shutdown()
