"""Trainables the port's Tune tests run in their trials.

They live here, away from the test modules, because a test module that
imports JAX would be imported by every trial that unpickles one of its
functions by reference. This module imports neither JAX nor the JAX
package, nor torch.
"""

import os
import tempfile
import time

from ray_tpu_torch import tune


def objective(config):
    score = (config["x"] - 3) ** 2
    for i in range(3):
        tune.report({"score": score + (2 - i) * 0.1, "x": config["x"]})


def _wait_for(path: str, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.01)


def paced_objective(config):
    """`tests/test_tune.py`'s `_long_objective` paced by the scheduler,
    not by sleeps: after each report the trial waits until the driver's
    scheduler has judged it (a file named by the trial's quality and the
    step, written by `AckScheduler`), so no trial runs ahead of the
    decisions about it."""
    for step in range(1, 17):
        loss = config["quality"] + 10.0 / step
        tune.report({"loss": loss})
        _wait_for(os.path.join(config["ack_dir"],
                               f"{config['quality']}_{step}"))


def pbt_objective(config):
    from ray_tpu_torch.train.checkpoint import Checkpoint

    start = 0
    ck = tune.get_checkpoint()
    if ck is not None:
        start = int(open(os.path.join(ck.path, "it.txt")).read())
    score = config["lr"] * 100
    for it in range(start, start + 8):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "it.txt"), "w") as f:
            f.write(str(it + 1))
        tune.report({"score": score + it * 0.01, "lr": config["lr"]},
                    checkpoint=Checkpoint(d))


def pb2_objective(config):
    for _ in range(12):
        time.sleep(0.03)
        # quality peaks at lr ~ 0.5 within [0, 1]
        tune.report({"score": 1.0 - (config["lr"] - 0.5) ** 2})


def meet_objective(config):
    """Writes its start file, then waits for the other trial's: it reports
    met=1 only if both trials were alive at once."""
    me = config["me"]
    other = {"a": "b", "b": "a"}[me]
    open(os.path.join(config["dir"], f"start_{me}"), "w").close()
    _wait_for(os.path.join(config["dir"], f"start_{other}"))
    met = int(os.path.exists(os.path.join(config["dir"], f"start_{other}")))
    tune.report({"met": met, "pid": os.getpid()})


def gpu_trial(config):
    """A trial on its share of the card: after meeting the sweep's other
    trial (as `meet_objective`), one gpt2-tiny forward through the flash
    kernel on the card; reports its launches of K1, counted in this
    process, and the device it ran on."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    me = config["me"]
    other = {"a": "b", "b": "a"}[me]
    open(os.path.join(config["dir"], f"start_{me}"), "w").close()
    _wait_for(os.path.join(config["dir"], f"start_{other}"))
    met = int(os.path.exists(os.path.join(config["dir"], f"start_{other}")))
    cfg = gpt2.GPT2Config.preset("gpt2-tiny", attn_impl="flash")
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    fa.flash_attention.launches = 0
    logits = gpt2.forward(params, tokens.to("cuda"), cfg)
    tune.report({"met": met, "pid": os.getpid(),
                 "launches": fa.flash_attention.launches,
                 "device": str(logits.device),
                 "finite": bool(torch.isfinite(logits).all())})
