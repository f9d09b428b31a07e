"""What the port's CLIs do around a run, on the CPU: the SIGUSR1 stack dump
that utils/logger.py registers (scripts/train_watchdog.sh sends SIGUSR1
before it kills a stalled run), the JAX preprocess CLI's command line
(--device-id, no effect) and the card each rank takes
(parallel/mesh.py::select_device).
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

from hpvaegan_tpu_torch import preprocess
from hpvaegan_tpu_torch.parallel import mesh
from hpvaegan_tpu_torch.utils import device as tdevice
from hpvaegan_tpu_torch.utils import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a process that registers the dump, signals itself, then lives on
_SIGNALLED = """
import os, signal, sys, time
from hpvaegan_tpu_torch.utils import logger
logger.{call}
print("ready", flush=True)
os.kill(os.getpid(), signal.SIGUSR1)
time.sleep(0.5)
print("alive", flush=True)
"""


@pytest.mark.parametrize("call", [
    "configure_logging()", "register_stack_dump()",
    "register_stack_dump(); logger.configure_logging()"])
def test_sigusr1_dumps_the_stack_and_the_process_lives_on(call):
    """After configure_logging (and register_stack_dump, which the train
    and eval CLIs call on every rank) `kill -USR1` prints every thread's
    Python stack to stderr; the process runs on and exits 0."""
    if not hasattr(signal, "SIGUSR1"):
        pytest.skip("no SIGUSR1 on this platform")
    res = subprocess.run([sys.executable, "-c",
                          _SIGNALLED.format(call=call)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ready", "alive"]
    assert "Current thread" in res.stderr or "Thread 0x" in res.stderr
    assert 'File "<string>", line' in res.stderr


def test_the_stack_dump_is_registered_once_a_process(monkeypatch):
    """The CLIs register it on every rank and configure_logging again on
    the primary: faulthandler sees one registration."""
    calls = []
    monkeypatch.setattr(logger, "_stack_dump_registered", False)
    monkeypatch.setattr(logger.faulthandler, "register",
                        lambda *a, **kw: calls.append((a, kw)))
    logger.register_stack_dump()
    logger.register_stack_dump()
    assert calls == [((signal.SIGUSR1,), {"all_threads": True})]


def test_the_jax_preprocess_command_line_parses():
    """The JAX package's preprocess.py flags, --device-id with them, parse
    in the port's CLI; --device-id changes nothing there."""
    argv = ["--exp-dir", "run/x/experiment_0", "--device-id", "3",
            "--scale-idx", "4", "--seed", "7", "--num-samples", "2",
            "--batch-size", "1"]
    args = preprocess.build_parser().parse_args(argv)
    assert (args.exp_dir, args.device_id, args.scale_idx, args.seed,
            args.num_samples, args.batch_size) == (
        "run/x/experiment_0", 3, 4, 7, 2, 1)


@pytest.mark.parametrize("device_id,local_rank,rank,want", [
    (0, None, -1, 0),   # one process
    (2, None, 1, 2),    # --device-id wins
    (0, "3", 1, 3),     # torchrun's LOCAL_RANK
    (0, None, 1, 1),    # --dist-procid 1 on a host of 4 cards
    (0, None, 6, 2),    # --dist-procid 6: the second host's third card
])
def test_each_rank_takes_its_own_card(monkeypatch, device_id, local_rank,
                                      rank, want):
    """select_device on a host of 4 cards: --device-id where given, else
    torchrun's LOCAL_RANK, else the explicit bootstrap's rank modulo the
    host's cards (NCCL refuses two ranks on one card), else card 0; the
    card is made current."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(tdevice, "resolve_device", torch.device)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    got = mesh.select_device("cuda", device_id, rank)
    assert got == torch.device("cuda", want) and current == [got]
    assert mesh.select_device("cpu", device_id, rank) == torch.device("cpu")
