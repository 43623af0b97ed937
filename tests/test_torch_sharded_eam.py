"""Port parity: the sharded EAM cellmc runner (parallel/cellmc_sharded.py,
kernels B3/B4 through their plain versions) on two gloo ranks, each a
process of its own (tests/torch_shard_worker.py), against the JAX
package's ``make_sharded_cellmc_run_fn`` (``shard_map``, interpret-mode
Pallas kernels) on two of the conftest's virtual CPU devices, on the
same inputs (tests/torch_chunk_case.py: 256 Al atoms at rc 3.8, R = 4, two
replicas a shard). Each record block restarts the shard's key chain at
key(2) with the shard index folded into the volume key and added to the
kernel seed word; the exchange runs on gathered values. Bit for bit:
``shift``, ``slot_of``, ``hist``, ``xacc``, the move counters; pe, box
and positions within torch_chunk_case's tolerances.
"""

import pytest
import torch

import torch_chunk_case as CC


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_eam_chunk_matches_jax(tmp_path):
    CC.sharded_matches_jax(CC.eam_case_inputs(tmp_path), tmp_path)
