"""What the recipe drivers share: their common flags, the stage
bookkeeping, the CLI commands and the launcher's job arrays (the Kaldi
`${train_cmd} JOB=1:N` role).

Every stage runs the package's CLIs as `python -m
svcc23_fastsvc_tpu_torch.bin.<cli>` processes, with the checkout on their
PYTHONPATH; those that run on a device get the driver's `--device`. Each
stage prints its seconds and how many processes it ran, and the driver's
last line is `stages {json}` with the same figures by stage.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from ..train.checkpoint import latest_checkpoint
from ..utils import launcher

# the checkout that holds the package, and the recipes' directory in it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EGS = os.path.join(REPO, "egs", "svcc23")
BIN = "svcc23_fastsvc_tpu_torch.bin"
# the CLIs that take --device; the rest run on the host
DEVICE_CLIS = {"extract_spk_embs", "preprocess_fastsvc", "train_fastsvc",
               "decode_fastsvc", "preprocess_b02", "train_b02",
               "decode_b02", "synthesize_b02"}


def base_parser(recipe: str, conf: str, stop_stage: int, tag: str,
                linguistic: list) -> argparse.ArgumentParser:
    """The flags both drivers take; `conf` and the F0 yaml default to the
    files of egs/svcc23/<recipe>/conf/ in this checkout."""
    p = argparse.ArgumentParser(description=f"The {recipe} recipe, stage "
                                            "by stage")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop-stage", type=int, default=stop_stage)
    p.add_argument("--conf", default=os.path.join(EGS, recipe, "conf", conf))
    p.add_argument("--f0-conf",
                   default=os.path.join(EGS, recipe, "conf", "f0.yml"))
    p.add_argument("--datadir", default="data")
    p.add_argument("--dumpdir", default="dump")
    p.add_argument("--expdir", default="exp")
    p.add_argument("--tag", default=tag)
    p.add_argument("--linguistic", default="logmel", choices=linguistic)
    p.add_argument("--cmd", default="local",
                   choices=["local", "ssh", "slurm", "sge"],
                   help="launcher backend for job arrays (cmd.sh role)")
    p.add_argument("--n-jobs", type=int, default=1,
                   help="stage 1 feature-extraction array width")
    p.add_argument("--hosts", default=None,
                   help="comma-separated host list for --cmd ssh")
    p.add_argument("--max-parallel", type=int, default=None,
                   help="cap on concurrently running array jobs")
    p.add_argument("--device", default="cuda",
                   help="passed to every CLI that runs on a device")
    return p


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def latest_pkl(directory: str) -> str:
    """The checkpoint of the most steps under `directory`
    (checkpoint-<N>steps.pkl); raises where there is none."""
    found = latest_checkpoint(directory)
    if found is None:
        raise FileNotFoundError(
            f"no checkpoint-<N>steps.pkl under {directory}")
    return found


class Driver:
    """Runs the stages a driver's `--stage` / `--stop-stage` select."""

    def __init__(self, args):
        self.args = args
        self.report = {}
        self._procs = 0

    def runs(self, stage: int) -> bool:
        return self.args.stage <= stage <= self.args.stop_stage

    @contextlib.contextmanager
    def stage(self, n: int):
        self._procs = 0
        t = time.perf_counter()
        yield
        s = time.perf_counter() - t
        self.report[n] = {"s": s, "processes": self._procs}
        print(f"stage {n}: {s:.3f} s, {self._procs} processes", flush=True)

    def command(self, mod: str, *args) -> list:
        cmd = [sys.executable, "-m", f"{BIN}.{mod}", *map(str, args)]
        if mod in DEVICE_CLIS:
            cmd += ["--device", self.args.device]
        return cmd

    def sh(self, mod: str, *args):
        cmd = self.command(mod, *args)
        print("+", " ".join(cmd), flush=True)
        self._procs += 1
        subprocess.run(cmd, check=True, env=_env())

    def sh_array(self, n_jobs: int, name: str, mod: str, *argv):
        """A {job}-templated CLI command as an n_jobs array through the
        launcher backend of `--cmd`, logs under <expdir>/log."""
        a = self.args
        cmd = self.command(mod, *argv)
        print(f"+ [{a.cmd} x{n_jobs}]", " ".join(cmd), flush=True)
        self._procs += n_jobs
        launcher.launch(
            cmd, n_jobs, backend=a.cmd,
            log_dir=os.path.join(a.expdir, "log"), name=name,
            max_parallel=a.max_parallel,
            hosts=a.hosts.split(",") if a.hosts else None,
            env={"PYTHONPATH": _env()["PYTHONPATH"]},
        )

    def finish(self):
        print("stages " + json.dumps(
            {str(k): v for k, v in sorted(self.report.items())}), flush=True)
