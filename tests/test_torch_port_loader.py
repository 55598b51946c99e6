"""The port's worker-process loader (``--loader_backend grain``,
``data/grain_pipeline.py``) on the CPU, 2 workers on a tiny corpus:

- unshuffled, its batches equal the JAX package's ``GrainLoader``'s, in
  order (grain runs here);
- shuffled, they equal the port's thread loader's over two epochs (the
  port takes the thread loader's shuffle stream, not grain's);
- a consumer that leaves after one batch, and a sample that raises, leave
  no worker process alive.

Each test runs under its own time limit (a SIGALRM deadline): a hung
worker fails its test instead of the run.
"""

import contextlib
import multiprocessing
import signal
import time

import numpy as np
import pytest

from omr_a2s_multimodal_transformer_tpu_torch.data import dataset as pds
from omr_a2s_multimodal_transformer_tpu_torch.data.grain_pipeline import GrainLoader
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

SYN = dict(n=7, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
WORKERS = 2


@contextlib.contextmanager
def deadline(seconds: int):
    def expire(*_):
        raise TimeoutError(f"the test ran over its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _ds(tmp_path, modality="both", module=pds):
    return module.ARDataset("synthetic", "train", krn_encoding="kern", input_modality=modality, synthetic=True,
                            synthetic_kwargs=SYN, cache_root=str(tmp_path))


def _host(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _assert_equal(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{what} batch {i} {k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} batch {i} {k}")


def _workers_gone(timeout=30.0) -> bool:
    end = time.monotonic() + timeout
    while multiprocessing.active_children():
        if time.monotonic() > end:
            return False
        time.sleep(0.1)
    return True


@pytest.mark.parametrize("modality", ["image", "both"])
def test_unshuffled_batches_equal_jax_grain_loader(tmp_path, modality):
    from omr_a2s_multimodal_transformer_tpu.data import dataset as jds
    from omr_a2s_multimodal_transformer_tpu.data.grain_pipeline import GrainLoader as JaxGrainLoader

    with deadline(240):
        want = [_host(b) for b in JaxGrainLoader(_ds(tmp_path / "j", modality, jds), 3, shuffle=False,
                                                 num_workers=WORKERS)]
        got = [_host(b) for b in GrainLoader(_ds(tmp_path / "p", modality), 3, shuffle=False, num_workers=WORKERS)]
        _assert_equal(got, want, f"grain {modality}")


def test_shuffled_batches_equal_thread_loader_over_two_epochs(tmp_path):
    with deadline(240):
        ds = _ds(tmp_path)
        threads = pds.Loader(ds, 3, shuffle=True, seed=5, drop_remainder=True, num_threads=2)
        workers = GrainLoader(ds, 3, shuffle=True, seed=5, drop_remainder=True, num_workers=WORKERS)
        assert len(workers) == len(threads) == 2
        for epoch in range(2):
            _assert_equal([_host(b) for b in workers], list(threads), f"epoch {epoch}")
        assert workers.epoch == threads.epoch == 2


class _Broken(pds.ARDataset):
    """A dataset whose sample 4 cannot be read (a module-level class, so a
    worker can unpickle it)."""

    def __getitem__(self, idx):
        if idx == 4:
            raise OSError(f"unreadable sample {idx}")
        return super().__getitem__(idx)


def test_early_exit_and_sample_error_leave_no_worker(tmp_path):
    with deadline(240):
        assert _workers_gone()
        loader = GrainLoader(_ds(tmp_path), 1, shuffle=False, num_workers=WORKERS)
        it = iter(loader)
        assert set(next(it)) == {"xi", "xi_hw", "frames_i", "xa", "xa_hw", "frames_a", "y_in", "y_out"}
        assert len(multiprocessing.active_children()) == WORKERS  # the workers run while the consumer reads
        del it  # the consumer leaves after one batch
        assert _workers_gone()
        broken = _Broken("synthetic", "train", krn_encoding="kern", input_modality="image", synthetic=True,
                         synthetic_kwargs=SYN, cache_root=str(tmp_path))
        with pytest.raises(OSError, match="unreadable sample 4"):
            list(GrainLoader(broken, 2, shuffle=False, num_workers=WORKERS))
        assert _workers_gone()
