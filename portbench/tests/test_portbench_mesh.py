"""The data-parallel training loop (traffic kind ``train_mesh``) at the
tiny sizes on 4 gloo ranks, from a copy of the benchmark that names its
cell: a sound run keeps every rank's trainables equal to rank 0's, and a
run whose ranks skip the gradients' exchange (each steps on its own clips)
reads above that and farther from the reference's first gradient; the
control (``control_mesh.py``, float8 operands over every rank's clips)
reads farther from it than the sound run."""

import json
import shutil

import pytest

from portbench import control_mesh
from portbench.tests.common import BENCH, MANIFEST, ROOT, rehearse

CELL = "train256_dp4"
SEED = 3_000_000_017
# the rehearsal's limits: the three numbers unbounded (the tiny model's
# readings set no limit of the cell), the ranks' agreement exact
LIMITS = {"loss_rel_gap": 1e9, "first_grad_leaf_gap": 1e9, "update_leaf_gap": 1e9, "rank_param_gap": 0.0}
# planted in every process of the run (the spawned ranks too): the
# gradients left as each rank computed them
NO_EXCHANGE = ("from i2v_adapter_tpu_torch.parallel import zero\n"
               "zero.Zero.sum_gradients = lambda self, grads: dict(grads)\n")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cell")
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": CELL, "config": "i2v_sd15_train", "traffic": "batch8_accum4_dp4", "chips": 4,
                           "why": "the data-parallel loop"})
    for x in m["end_to_end"]:
        if "train256_b8" in x.get("workloads", []):
            x["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (root / "portbench/limits" / f"{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    fault = root / "fault"
    fault.mkdir()
    (fault / "sitecustomize.py").write_text(NO_EXCHANGE)
    return root


def _checks(copy, extra_path):
    rc, line, err = rehearse(CELL, cwd=copy, extra_path=extra_path, seed=SEED)
    assert rc == 0, err[-3000:]
    return line


def test_ranks_agree_and_the_exchange_and_the_control_are_checked(copy, capsys):
    sound = _checks(copy, str(ROOT))
    assert sound["correct"] is True and sound["checks"]["rank_param_gap"]["value"] == 0.0
    assert set(sound["metrics"]) == {"train_clips_per_s", "peak_mem_gib", "setup_s"}
    faulty = _checks(copy, f"{copy / 'fault'}:{ROOT}")
    assert faulty["correct"] is False and faulty["checks"]["rank_param_gap"]["value"] > 0
    gap = lambda line: line["checks"]["first_grad_leaf_gap"]["value"]  # noqa: E731
    assert gap(faulty) > 10 * gap(sound)
    assert control_mesh.main(["--config", "i2v_sd15_train", "--traffic", "batch8_accum4_dp4", "--seeds",
                              str(SEED), "--rehearse"]) == 0
    control = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["control"]
    assert set(control) == set(LIMITS) - {"rank_param_gap"}
    assert control["first_grad_leaf_gap"] > 10 * gap(sound)
