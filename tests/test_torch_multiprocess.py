"""Multi-process runs of the port from the reference's environment
(``tests/test_multiprocess.py``): k OS processes on this host meet
through ``PS_COORDINATOR_URI`` / ``PS_NUM_PROCESSES`` / ``PS_PROCESS_ID``
(``Config.from_env``), form one gloo process group on the CPU and run
steps whose gradient reductions cross the process boundary. Parity: a
2-process run equals one process over the same global batches (rtol
1e-5, the reference's), its ranks agree, and a 2-process save restored
by a new 2-process group continues as an uninterrupted run (rtol 1e-6).
The Wide-&-Deep, ResNet-50, BERT (sharded LAMB) and async MNIST trainers
run as 2 processes from the same variables.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.models.mlp import MLP

ENV = {"PS_COORDINATOR_URI": "127.0.0.1:{port}", "PS_NUM_PROCESSES": "{k}",
       "PS_PROCESS_ID": "{rank}"}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params():
    model = MLP(hidden=16)
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])


def _steps_case(steps):
    return ("dense_steps", dict(params=_params(),
                                batches=list(mnist_batches(16, steps=steps)),
                                optimizer="sgd", opt_kw={"learning_rate": 0.1},
                                placement="sharded", hidden=16))


def test_two_process_rendezvous_and_parity(tmp_path):
    two = torch_ranks.run_ranks(2, [_steps_case(3)], tmp_path, env=ENV)
    assert [r[0]["num_workers"] for r in two] == [2, 2]
    np.testing.assert_allclose(two[0][0]["losses"], two[1][0]["losses"],
                               rtol=1e-6)
    ps_tpu_torch.init(backend="cuda", device="cpu")
    try:
        name, kw = _steps_case(3)
        one = torch_ranks.CASES[name](0, 1, **kw)
    finally:
        ps_tpu_torch.shutdown()
    np.testing.assert_allclose(two[0][0]["losses"], one["losses"], rtol=1e-5)
    for key, want in one["params"].items():
        for r in two:
            np.testing.assert_allclose(r[0]["params"][key], want, rtol=1e-5,
                                       atol=1e-6)


def test_four_process_rendezvous(tmp_path):
    four = torch_ranks.run_ranks(4, [_steps_case(2)], tmp_path, env=ENV)
    base = four[0][0]
    assert base["num_workers"] == 4
    for r in four[1:]:
        np.testing.assert_allclose(r[0]["losses"], base["losses"], rtol=1e-6)


def test_multiprocess_checkpoint_resume_parity(tmp_path):
    """A 2-process save, restored by a new 2-process group, continues as an
    uninterrupted 4-step run; one committed generation holds both ranks'
    files."""
    path = str(tmp_path / "ckpt")
    common = dict(params=_params(), batches=list(mnist_batches(16, steps=4)),
                  path=path, hidden=16)
    saved = torch_ranks.run_ranks(2, [("ckpt", dict(common, steps=4)),
                                      ("ckpt", dict(common, steps=2,
                                                    save=True))],
                                  tmp_path, env=ENV)
    resumed = torch_ranks.run_ranks(2, [("ckpt", dict(
        common, steps=2, restore="strict"))], tmp_path, env=ENV)
    dirs = [d for d in os.listdir(path) if d.startswith("arrays-")]
    assert dirs == [saved[0][1]["meta"]["arrays_dir"]]
    straight = saved[0][0]
    np.testing.assert_allclose(saved[0][1]["losses"] + resumed[0][0]["losses"],
                               straight["losses"], rtol=1e-6)
    for key, want in straight["params"].items():
        np.testing.assert_allclose(resumed[0][0]["params"][key], want,
                                   rtol=1e-6, atol=1e-7)


def _trainer(module, args, tmp_path, k):
    """Run a trainer as k processes (or one, k=1) from the PS_* variables;
    each writes its step records to out<rank>.jsonl."""
    port = torch_ranks.free_port()
    env = {key: v for key, v in os.environ.items()
           if key not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(k):
        e = dict(env)
        if k > 1:
            e.update({"PS_COORDINATOR_URI": f"127.0.0.1:{port}",
                      "PS_NUM_PROCESSES": str(k), "PS_PROCESS_ID": str(r)})
        out = str(tmp_path / f"{module.rsplit('.', 1)[1]}-{k}-{r}.jsonl")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", module, *args, "--jsonl", out],
            cwd=_REPO, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    losses = []
    for p, out in procs:
        log = p.communicate(timeout=240)[0]
        assert p.returncode == 0, log[-4000:]
        with open(out) as f:
            losses.append([json.loads(line)["loss"] for line in f])
    return losses


def test_trainers_run_as_two_processes_from_the_environment(tmp_path):
    """Both trainers as 2 processes, each rank on its slice of the same
    global batches, report the one-process run's losses (rtol 1e-5)."""
    for module, args in (
            ("ps_tpu_torch.examples.train_widedeep",
             ["--device", "cpu", "--steps", "3", "--vocab", "20",
              "--batch-size", "8", "--exchange", "a2a",
              "--capacity-factor", "2"]),
            ("ps_tpu_torch.examples.train_resnet50",
             ["--device", "cpu", "--steps", "2", "--batch-size", "4",
              "--image-size", "32", "--dtype", "float32"])):
        one = _trainer(module, args, tmp_path, 1)[0]
        two = _trainer(module, args, tmp_path, 2)
        assert len(one) >= 2, module
        for losses in two:
            np.testing.assert_allclose(losses, one, rtol=1e-5, err_msg=module)


def test_bert_and_async_trainers_run_as_two_processes(tmp_path):
    """BERT-tiny at the trainer's default placement (sharded LAMB) and the
    async MNIST trainer's single role, as 2 processes, report the
    one-process run's losses (rtol 1e-5)."""
    for module, args in (
            ("ps_tpu_torch.examples.train_bert_mlm",
             ["--device", "cpu", "--size", "tiny", "--steps", "3",
              "--seq-len", "32", "--batch-size", "8", "--dtype",
              "float32"]),
            ("ps_tpu_torch.examples.train_mnist_async",
             ["--device", "cpu", "--steps", "30"])):
        one = _trainer(module, args, tmp_path, 1)[0]
        two = _trainer(module, args, tmp_path, 2)
        assert len(one) >= 2, module
        for losses in two:
            np.testing.assert_allclose(losses, one, rtol=1e-5, err_msg=module)
