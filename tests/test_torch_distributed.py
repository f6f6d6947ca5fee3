"""The port's rendezvous and data parallelism on the CPU: rank and world
from each launcher's variables, the mesh helpers, and ``make_train_step``
over DDP with gloo in 2 processes, whose replicas stay equal and take the
single-process step of the whole batch (bn0's statistics over both ranks).

Tolerances: the replicas against each other exactly (DDP averages the same
gradients on every rank); against one process ``atol=2e-5, rtol=1e-4`` on
every parameter and buffer and ``rtol=1e-5`` on the losses (the same f32
program, the batch's sums split over two ranks).
"""

import numpy as np
import pytest
import torch

from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.parallel import distributed as t_dist
from audio_residual_tpu_torch.parallel import mesh as t_mesh
from audio_residual_tpu_torch.training import train_clap as t_tc

from . import torch_dist_workers as dw
from . import torch_port_fixture as fx

LAUNCHERS = {
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1"},
    "openmpi": {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8",
                "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
    "pmi": {"PMI_RANK": "3", "PMI_SIZE": "8", "MPI_LOCALRANKID": "1"},
    "torchrun": {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1"},
}
ALL_VARS = {v for env in LAUNCHERS.values() for v in env} | {
    "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"}


@pytest.fixture
def clean_env(monkeypatch):
    for v in ALL_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.mark.parametrize("launcher", list(LAUNCHERS))
def test_world_info_from_each_launcher(clean_env, launcher):
    for k, v in LAUNCHERS[launcher].items():
        clean_env.setenv(k, v)
    clean_env.setenv("MASTER_ADDR", "node7")
    clean_env.setenv("MASTER_PORT", "29500")
    assert t_dist.world_info_from_env() == (3, 8, "node7:29500")
    assert t_dist._local_rank(3) == 1


def test_world_info_defaults_and_coordinator(clean_env):
    assert t_dist.world_info_from_env() == (0, 1, None)
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    clean_env.setenv("MASTER_PORT", "29500")
    assert t_dist.world_info_from_env() == (0, 2, "10.0.0.1:1234")
    clean_env.setenv("SLURM_PROCID", "1")
    clean_env.setenv("SLURM_NTASKS", "2")
    assert t_dist.world_info_from_env()[0] == 1  # SLURM is read first


def test_single_process_world_initialises_nothing(clean_env):
    info = t_dist.init_distributed(device="cpu")
    assert info == {"rank": 0, "world_size": 1, "local_rank": 0, "device": torch.device("cpu")}
    assert not torch.distributed.is_initialized()


def test_init_distributed_without_device_needs_a_card(clean_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dist.init_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.data_parallel_mesh()


def test_mesh_of_one_process(clean_env):
    mesh = t_mesh.data_parallel_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    module = torch.nn.Linear(2, 2)
    assert t_mesh.replicate(mesh, module) is module
    batch = t_mesh.shard_batch(mesh, {"x": np.arange(6).reshape(3, 2)})
    assert torch.equal(batch["x"], torch.arange(6).reshape(3, 2))
    with pytest.raises(ValueError, match="world of 2"):
        t_mesh.data_parallel_mesh(2, device="cpu")


def test_shard_batch_gives_each_rank_its_rows():
    x = np.arange(8)
    for rank in range(2):
        mesh = t_mesh.DataParallelMesh(None, rank, 2, torch.device("cpu"))
        assert t_mesh.shard_batch(mesh, {"x": x})["x"].tolist() == list(range(4 * rank,
                                                                                4 * rank + 4))
    with pytest.raises(ValueError, match="does not split"):
        t_mesh.shard_batch(t_mesh.DataParallelMesh(None, 0, 3, torch.device("cpu")), {"x": x})


STEPS = 2


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    return dw.run("train_worker", 2, str(tmp_path_factory.mktemp("ddp")), STEPS)


def test_ddp_replicas_stay_equal(replicas):
    a, b = (r["state_dict"] for r in replicas)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert replicas[0]["losses"] == replicas[1]["losses"]


def test_ddp_step_is_the_single_process_step(replicas):
    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = t_tc.make_optimizer(model, lr=1e-4, warmup=1, total_steps=10, eps=1e-3,
                              weight_decay=0.1)
    state = t_tc.init_train_state(model, opt)
    step = t_tc.make_train_step(model, opt)
    batch = {k: torch.as_tensor(v) for k, v in dw.train_batch().items()}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(replicas[0]["losses"], losses, rtol=1e-5)
    got = replicas[0]["state_dict"]
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-5, rtol=1e-4, err_msg=k)
    assert not torch.equal(got["audio_branch.bn0.running_mean"],
                           before["audio_branch.bn0.running_mean"])
