"""The port's recipe drivers run what the JAX drivers run.

Each JAX driver (`egs/svcc23/{fastsvc1,baseline02}/run.py`, imported from
its file) and the port's (`svcc23_fastsvc_tpu_torch.recipes.*`) run over
every stage with `subprocess.run` and the launcher's `launch` recording
instead of running, at `--n-jobs` 1 and 2, each linguistic front end. The
two lists of commands and job arrays must be equal once the module names
are mapped (`svcc23_fastsvc_tpu.bin.X` -> `svcc23_fastsvc_tpu_torch.bin.X`)
and these two differences are taken out:

* `--device <d>`, which the port passes to every CLI that runs on a
  device;
* `--checkpoint <pkl>` where JAX passes `--checkpoint-dir <dir>`: the
  port's decode and synthesis CLIs read one `.pkl`, the latest under that
  directory when the stage starts.

The FastSVC driver's `--n-procs 2` commands are held to JAX's the same
way, with and without `--proc-id`. Beside them: on the card a K-step call
with a gloo data group raises rather than runs eagerly.
"""

import importlib.util
import os
import socket
import subprocess
import sys

import pytest

from svcc23_fastsvc_tpu.utils import launcher as jax_launcher
from svcc23_fastsvc_tpu_torch.recipes import baseline02, fastsvc1
from svcc23_fastsvc_tpu_torch.utils import launcher as port_launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"fastsvc1": fastsvc1, "baseline02": baseline02}
TAG = {"fastsvc1": "fastsvc", "baseline02": "taco2"}
# extra flags of each variant: the default front end, and the pretrained
# linguistic and speaker models
VARIANTS = {
    "fastsvc1": {"default": [],
                 "models": ["--linguistic", "conformer", "--ppg-checkpoint",
                            "ppg.pth", "--xvector-checkpoint", "xv.ckpt",
                            "--speakers", "spkB", "spkC"]},
    "baseline02": {"default": ["--vocoder-dir", "voc"],
                   "models": ["--linguistic", "hubert", "--hubert-checkpoint",
                              "hubert.pt", "--vocoder-dir", "voc",
                              "--speakers", "spkB"]},
}


def _jax_driver(recipe):
    spec = importlib.util.spec_from_file_location(
        f"jax_run_{recipe}", os.path.join(REPO, "egs", "svcc23", recipe,
                                          "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def recipe_dir(tmp_path, monkeypatch):
    """The files whose presence the drivers test: both wav.scp files, the
    dump directories, a training checkpoint and a vocoder."""
    for split in ("train", "dev"):
        (tmp_path / "data" / split).mkdir(parents=True)
        (tmp_path / "data" / split / "wav.scp").write_text("")
        for norm in ("", "_norm"):
            (tmp_path / "dump" / f"{split}{norm}").mkdir(parents=True,
                                                         exist_ok=True)
    (tmp_path / "conf.yaml").write_text("")
    (tmp_path / "f0.yml").write_text("")
    (tmp_path / "f0_stats.yml").write_text("")
    for tag in TAG.values():
        (tmp_path / "exp" / tag).mkdir(parents=True)
        for steps in (4, 12):
            (tmp_path / "exp" / tag / f"checkpoint-{steps}steps.pkl"
             ).write_text("")
    (tmp_path / "voc").mkdir()
    (tmp_path / "voc" / "checkpoint-7steps.pkl").write_text("")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _record(monkeypatch, launcher_module):
    calls = []

    def run(cmd, check=False, env=None, **kw):
        calls.append(("run", list(cmd)))
        return subprocess.CompletedProcess(cmd, 0)

    def launch(argv, n_jobs, **kw):
        calls.append(("launch", list(argv), n_jobs,
                      {k: v for k, v in kw.items()}))
        return []

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(launcher_module, "launch", launch)
    return calls


def _mapped(cmd):
    """A port command as the JAX driver would have written it."""
    reads_pkl = cmd[2].endswith(("decode_fastsvc", "decode_b02",
                                 "synthesize_b02"))
    out, i = [], 0
    while i < len(cmd):
        a = cmd[i]
        if a == "--device":
            i += 2
            continue
        if a == "--checkpoint" and reads_pkl:
            path = cmd[i + 1]
            assert path.endswith(("checkpoint-12steps.pkl",
                                  "checkpoint-7steps.pkl")), path
            out += ["--checkpoint-dir", os.path.dirname(path)]
            i += 2
            continue
        out.append(a.replace("svcc23_fastsvc_tpu_torch.bin.",
                             "svcc23_fastsvc_tpu.bin."))
        i += 1
    return out


@pytest.mark.parametrize("variant", ["default", "models"])
@pytest.mark.parametrize("n_jobs", [1, 2])
@pytest.mark.parametrize("recipe", ["fastsvc1", "baseline02"])
def test_port_driver_runs_the_jax_drivers_commands(recipe, n_jobs, variant,
                                                   recipe_dir, monkeypatch):
    argv = ["--conf", "conf.yaml", "--f0-conf", "f0.yml", "--n-jobs",
            str(n_jobs), *VARIANTS[recipe][variant]]
    if recipe == "baseline02":
        argv += ["--f0-stats", "f0_stats.yml"]
    jax_driver = _jax_driver(recipe)
    want = _record(monkeypatch, jax_launcher)
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    jax_driver.main()
    got = _record(monkeypatch, port_launcher)
    report = PORT[recipe].main([*argv, "--device", "cpu"])

    stages = [0, 1, 2, 3, 4, 5] + ([7] if recipe == "baseline02" else [])
    assert sorted(report) == stages
    assert len(got) == len(want) == 9
    assert sum(g[0] == "launch" for g in got) == (2 if n_jobs > 1 else 0)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert _mapped(g[1]) == w[1]
        if g[0] == "launch":
            assert g[2] == w[2] == n_jobs
            assert g[3] == w[3]
    device = {"extract_spk_embs", "preprocess_fastsvc", "preprocess_b02",
              "train_fastsvc", "train_b02", "decode_fastsvc", "decode_b02",
              "synthesize_b02"}
    for g in got:
        mod = g[1][2].rsplit(".", 1)[1]
        assert ("--device" in g[1]) == (mod in device), g[1]
        if mod in device:
            assert g[1][g[1].index("--device") + 1] == "cpu"
    # every stage counts the processes it ran
    assert sum(r["processes"] for r in report.values()) == (
        len(got) + sum(n_jobs - 1 for g in got if g[0] == "launch"))


@pytest.mark.parametrize("proc_id", [None, 0, 1])
def test_port_driver_runs_the_jax_drivers_multi_process_commands(
        proc_id, recipe_dir, monkeypatch):
    """`--n-procs 2`: without `--proc-id` every stage runs here and stage 4
    places both training ranks through the launcher; with one, stage 1
    extracts that process's shard, stage 4 runs that rank, and stages 0,
    2, 3 and 5 run on process 0 only: the JAX driver's commands each
    time."""
    argv = ["--conf", "conf.yaml", "--f0-conf", "f0.yml", "--n-procs", "2",
            "--coordinator", "10.0.0.1:4242"]
    if proc_id is not None:
        argv += ["--proc-id", str(proc_id)]
    jax_driver = _jax_driver("fastsvc1")
    want = _record(monkeypatch, jax_launcher)
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    jax_driver.main()
    got = _record(monkeypatch, port_launcher)
    report = fastsvc1.main([*argv, "--device", "cpu"])

    stages = [0, 1, 2, 3, 4, 5] if proc_id in (None, 0) else [1, 4]
    assert sorted(report) == stages
    assert len(got) == len(want) == (9 if proc_id in (None, 0) else 3)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert _mapped(g[1]) == w[1]
        if g[0] == "launch":
            assert g[2] == w[2]
            assert g[3] == w[3]
    train = [g for g in got if "train_fastsvc" in g[1][2]]
    assert len(train) == 1
    if proc_id is None:  # the launcher's array of the two ranks
        assert train[0][0] == "launch" and train[0][2] == 2
        assert ["--proc-id", "{job}"] == train[0][1][-6:-4]
    else:
        assert train[0][0] == "run"
        i = train[0][1].index("--proc-id")
        assert train[0][1][i + 1] == str(proc_id)
    shards = [g[1] for g in got if "preprocess_fastsvc" in g[1][2]]
    assert len(shards) == 2  # train and dev
    for cmd in shards:
        assert ("--shard-id" in cmd) == (proc_id is not None)


def test_port_driver_refuses_scale_out(recipe_dir, capsys):
    """A `--proc-id` that names no process of `--n-procs` is refused."""
    with pytest.raises(SystemExit):
        fastsvc1.main(["--n-procs", "2", "--proc-id", "2"])
    assert "--proc-id 2 is not a process of --n-procs 2" in \
        capsys.readouterr().err


def test_captured_k_steps_refuse_a_gloo_group(monkeypatch):
    """On the card a K-step call is one captured CUDA graph, and only NCCL
    collectives can be captured: `StepGraphs` (which `Trainer` builds for
    steps_per_call > 1 on the card) raises for a task with a gloo data
    group rather than run the steps eagerly. On the CPU, with the task's
    device check patched to say cuda, over a one-rank gloo group."""
    import torch
    import torch.distributed as dist

    from svcc23_fastsvc_tpu_torch.train.gan import FastSVCTrainTask
    from svcc23_fastsvc_tpu_torch.train.graphs import StepGraphs

    class Task(FastSVCTrainTask):
        device = torch.device("cuda")

    task = Task(generator=None, discriminator=None, g_opt=None, d_opt=None,
                signal_generator=None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        task.dp_group = dist.group.WORLD
        with pytest.raises(ValueError, match="only NCCL"):
            StepGraphs(task)
    finally:
        dist.destroy_process_group()
