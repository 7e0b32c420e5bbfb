"""The port's training launcher (``repro_torch.launch.train``) on the CPU at
``reduced`` sizes: ``main`` trains, refuses to fall back to the CPU
without a card, and a run killed after a checkpoint and restarted gives
the uninterrupted run's losses exactly (same seed, same device, the same
ops in the same order); and a run leaves none of its tensors to the
garbage collector.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from torch_threads import one_thread  # noqa: F401


def _argv(arch, steps, *extra):
    return ["--arch", arch, "--reduced", "--steps", str(steps), "--batch",
            "2", "--seq", "16", "--device", "cpu", "--log-every", "1",
            *extra]


def test_main_trains_reduced(capsys):
    from repro_torch.launch import train as LT
    hist = LT.main(_argv("granite-8b", 10, "--schedule", "wsd"))
    assert [h["step"] for h in hist] == list(range(1, 11))
    assert all(np.isfinite(h["loss"]) and h["ms"] > 0 for h in hist)
    assert hist[0]["lr"] == 0.0 and hist[1]["lr"] > 0.0   # wsd warmup
    out = capsys.readouterr().out
    assert "arch=granite-8b" in out and "done: 10 steps" in out


def test_main_refuses_without_a_card():
    from repro_torch.launch import train as LT
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LT.main(["--arch", "granite-8b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch,extra", [
    ("granite-8b", ()), ("musicgen-medium", ("--compress",))])
def test_restart_equals_uninterrupted(tmp_path, arch, extra):
    """A run checkpointed at step 2 and restarted gives the uninterrupted
    run's later losses exactly (CPU, same seed): the state (weights, AdamW
    moments, the compressor's residual, the step) and the data and input
    embeddings of each step survive the restart."""
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.launch import train as LT
    whole = LT.main(_argv(arch, 4, *extra))
    d = str(tmp_path / "ck")
    cfg = reduced(get_config(arch))
    _, first = LT.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=d,
                        ckpt_every=2, compress=bool(extra), until=3,
                        dtype=torch.float32, device="cpu",
                        log=lambda *_: None)
    assert len(first) == 3 and latest_step(d) == 2    # killed after step 3
    rest = LT.main(_argv(arch, 4, "--ckpt-dir", d, *extra))
    assert [h["step"] for h in rest] == [3, 4] and latest_step(d) == 4
    first = first[:2]
    for a, b in zip(first + rest, whole):
        for k in ("loss", "grad_norm", "lr", "aux_loss"):
            assert a[k] == b[k], (a["step"], k)
    # the cadence path: saves at 2 and 4; a job lost before its last save
    d2 = str(tmp_path / "ck2")
    LT.main(_argv(arch, 4, "--ckpt-dir", d2, "--ckpt-every", "2", *extra))
    import shutil
    shutil.rmtree(f"{d2}/step_000000004")
    again = LT.main(_argv(arch, 4, "--ckpt-dir", d2, *extra))
    assert [h["loss"] for h in again] == [h["loss"] for h in whole[2:]]


def test_train_leaves_no_tensor_in_a_cycle(tmp_path):
    """With the garbage collector off, a run (remat, the compressor, a
    checkpoint and a restart) frees every tensor by reference counting
    once its state is dropped.  A tensor left in a reference cycle stays
    until a full collection; on the card that was a previous run's
    gigabytes, and the next full-width run ran out of memory."""
    import gc
    from repro_torch.launch import train as LT
    cfg = reduced(get_config("gemma2-2b"))
    kw = dict(steps=4, batch=2, seq=16, compress=True, ckpt_dir=str(
        tmp_path / "ck"), ckpt_every=2, dtype=torch.float32, device="cpu",
        log=lambda *_: None)
    was, flags = gc.isenabled(), gc.get_debug()
    gc.collect()
    gc.disable()
    try:
        for until in (2, 3):             # the second run restores step 2
            state, hist = LT.train(cfg, until=until, **kw)
            assert len(hist) == {2: 2, 3: 1}[until]
            del state, hist
            gc.set_debug(gc.DEBUG_SAVEALL)
            gc.collect()
            kept = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
            gc.garbage.clear()
            gc.set_debug(flags)
            assert not kept, f"{len(kept)} tensors in reference cycles"
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        if was:
            gc.enable()
