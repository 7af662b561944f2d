"""The port's 2-rank train step with YoloLossOTA and with accum_steps=2, on
the CPU over gloo, against the port in one process and JAX's step on a
2-device CPU mesh (tests/test_torch_distributed.py has the plain step and
its tolerances). With accum_steps=2 microbatch k on rank r holds the rows
that JAX's device r holds of microbatch k (parallel/mesh.py:shard_rows).
A file of its own, so that its two JAX compiles run beside the other
file's on another worker.
"""

import pytest
import torch

from test_torch_distributed import check_jax, check_one_process, check_ranks, start_cases

torch.set_num_threads(2)

JAX_CASES = {"ota": (dict(seed=9), dict(loss="ota")),
             "accum2": (dict(seed=10), dict(accum_steps=2))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    got, want, _ = start_cases(str(tmp_path_factory.mktemp("ddp_options")), JAX_CASES)
    return got, want


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_two_rank_step_option_matches_jax_and_one_process(runs, case):
    got, want = runs
    check_ranks(got[case])
    check_one_process(got[case])
    check_jax(got[case], want[case])
