"""train_video_baselines on the spatial mesh (--mesh-sp, parallel/
spatial.py) over gloo ranks on the CPU, held against one process, with
the helpers and rank cases of test_torch_spatial_training.py (a file of
its own, so that each file stays small under xdist's loadfile).

  * On the pyramid 12 15 17 20 24 (12, 20 and 24 split, 15 and 17 whole;
    num_layer 1, so CSG's stages pad by 2, SG's by 3 and the critic by 3,
    and at S = 4 the edge ranks hold more rows than the middle ones):
    GeneratorCSG with --mesh-sp 4 on 4 ranks and GeneratorSG with
    --mesh-data 2 --mesh-sp 2 on 4 ranks, each against one process at
    --batch-size D: every rank bit-equal, one experiment dir, netG_k and
    the amps within the data axis's multi-scale bar (atol 1e-4, but for
    the biases in front of BatchNorm).
  * A GeneratorCSG run at --mesh-sp 4 killed at its last scale and
    resumed from its inflight checkpoint ends bit for bit as the
    uninterrupted run.

Ranks run this file as a script (test_torch_multihost.py::run_ranks).
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))

from test_torch_data_parallel import (MULTI_SCALE_TOL,  # noqa: E402
                                      _bias_fed_batchnorm)
from test_torch_data_parallel import restore_logging  # noqa: E402,F401
from test_torch_multihost import run_ranks, worker_main  # noqa: E402
from test_torch_spatial_training import (_batch, _case_cli,  # noqa: E402
                                         _case_resume, _train)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,data_ranks,sp", [("baselines", 1, 4),
                                               ("baselines-sg", 2, 2)])
def test_spatial_baselines_cli_equals_one_process(tmp_path, kind, data_ranks,
                                                  sp, restore_logging):
    """train_video_baselines (GeneratorCSG at --mesh-sp 4, GeneratorSG at
    --mesh-data 2 --mesh-sp 2) over D x S ranks against one process at
    --batch-size D: every rank bit-equal, one experiment dir, netG_k and
    the amps within the data axis's multi-scale bar."""
    outs = run_ranks(__file__, "cli", tmp_path, kind, data_ranks,
                     world=data_ranks * sp)
    for out in outs[1:]:
        for k, v in outs[0]["sd"].items():
            assert torch.equal(v, out["sd"][k]), k
        assert out["amps"] == outs[0]["amps"]
        assert (out["saver"], out["exp"]) == ("NullSaver", outs[0]["exp"])
    r0 = outs[0]
    assert r0["saver"] == "DataSaver"
    assert glob.glob(os.path.join(tmp_path, "sp", "**", "experiment_*"),
                     recursive=True) == [r0["exp"]]
    names = set(os.listdir(r0["exp"]))
    assert {f"net{n}_{k}.ckpt" for n in "GD" for k in range(5)} \
        | {"Z_init.npy"} <= names
    with open(os.path.join(r0["exp"], "args.txt")) as f:
        args = f.read()
    assert f"mesh_sp: {sp}" in args and f"mesh_data: {data_ranks}" in args

    one = _train(kind, str(tmp_path / "one"), _batch(kind, data_ranks))
    assert len(one["amps"]) == 5 and all(a > 0 for a in one["amps"])
    np.testing.assert_allclose(r0["amps"], one["amps"], **MULTI_SCALE_TOL)
    absorbed = _bias_fed_batchnorm(one["sd"])
    for k, v in one["sd"].items():
        if k not in absorbed:
            np.testing.assert_allclose(r0["sd"][k].numpy(), v.numpy(),
                                       err_msg=k, **MULTI_SCALE_TOL)


def test_spatial_baselines_inflight_resume_is_exact(tmp_path,
                                                   restore_logging):
    """train_video_baselines --mesh-sp 4 killed at its last scale and
    resumed from its inflight checkpoint ends as the uninterrupted run,
    bit for bit, on all four ranks (the state and Z_init are replicated:
    the checkpoint needs no gather)."""
    outs = run_ranks(__file__, "resume", tmp_path, "baselines", world=4)
    for out in outs:
        assert out["resumed"]["amps"] == out["whole"]["amps"]
        for k, v in out["whole"]["sd"].items():
            assert torch.equal(out["resumed"]["sd"][k], v), k
            assert torch.equal(outs[0]["whole"]["sd"][k], v), k


CASES = {"cli": _case_cli, "resume": _case_resume}

if __name__ == "__main__":
    worker_main(CASES)
