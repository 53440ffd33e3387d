"""Job-array launcher: the Kaldi cmd.sh layer of the recipes, as a
library. A copy of `svcc23_fastsvc_tpu/utils/launcher.py`, which depends
on no framework.

The reference recipes drive every stage through Kaldi's Perl runners
selected by ``cmd_backend`` in cmd.sh: ``run.pl`` (local fork),
``slurm.pl`` (sbatch), ``ssh.pl`` (host list), ``queue.pl`` (SGE), all
sharing the ``cmd JOB=1:N log command`` array-job interface:

    launch(["python", "-m", "...preprocess_fastsvc",
            "--n-shards", "{n_jobs}", "--shard-id", "{job}"],
           n_jobs=8, backend="local", log_dir="exp/log", name="preprocess")

``{job}`` / ``{n_jobs}`` placeholders are substituted per job (0-based, the
CLIs' --shard-id convention; Kaldi's JOB=1:N was 1-based). Every job
logs to ``<log_dir>/<name>.<job>.log``; like run.pl, the launcher waits for
the whole array and raises with the failing logs' tails if any job exits
nonzero.

Backends:
  * ``local`` — process fan-out on this host, capped at ``max_parallel``
    (run.pl's role). Feature extraction is embarrassingly parallel over scp
    shards, so a multi-core host overlaps the serial DSP (Harvest) with the
    extractors on the device.
  * ``ssh`` — round-robin over ``hosts`` (ssh.pl's role). Jobs run in the
    same cwd on the remote side (shared filesystem assumed, as in Kaldi).
  * ``slurm`` — one ``sbatch --array=0-(N-1) --wait`` submission
    (slurm.pl's role); ``$SLURM_ARRAY_TASK_ID`` becomes ``{job}``.
  * ``sge`` — one ``qsub -t 1-N -sync y`` submission (queue.pl's role;
    default qsub options mirror its "command qsub -v PATH -cwd -S
    /bin/bash -j y" template line). SGE task ids are 1-based; the
    generated script maps ``$((SGE_TASK_ID - 1))`` onto the 0-based
    ``{job}`` and self-redirects to the same ``<log_dir>/<name>.<job>.log``
    naming as every other backend. ``max_parallel`` becomes ``-tc``
    (queue.pl's max_jobs_run).

This module only places processes; the CLIs it runs stay launcher-agnostic.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class JobResult:
    job: int
    returncode: int
    log: str


def _substitute(argv: Sequence[str], job: int, n_jobs: int) -> list:
    return [
        str(a).replace("{job}", str(job)).replace("{n_jobs}", str(n_jobs))
        for a in argv
    ]


def _tail(path: str, n: int = 20) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def _raise_on_failure(results: list, name: str):
    failed = [r for r in results if r.returncode != 0]
    if failed:
        worst = failed[0]
        raise RuntimeError(
            f"{len(failed)} of {len(results)} '{name}' jobs failed "
            f"(first: job {worst.job}, rc {worst.returncode}, log {worst.log})\n"
            f"--- log tail ---\n{_tail(worst.log)}"
        )


def _run_popen_array(cmds: list, logs: list, *, max_parallel: int,
                     env: Optional[dict], cwd: Optional[str],
                     name: str) -> list:
    """Fan out len(cmds) processes, at most max_parallel in flight."""
    results: list = [None] * len(cmds)
    running: dict = {}
    nxt = 0
    while nxt < len(cmds) or running:
        while nxt < len(cmds) and len(running) < max_parallel:
            log_f = open(logs[nxt], "w")
            log_f.write("# " + " ".join(map(shlex.quote, cmds[nxt])) + "\n")
            log_f.flush()
            proc = subprocess.Popen(
                cmds[nxt], stdout=log_f, stderr=subprocess.STDOUT,
                env=env, cwd=cwd,
            )
            running[nxt] = (proc, log_f)
            nxt += 1
        done = [j for j, (p, _) in running.items() if p.poll() is not None]
        if not done:
            time.sleep(0.05)
            continue
        for j in done:
            proc, log_f = running.pop(j)
            log_f.close()
            results[j] = JobResult(job=j, returncode=proc.returncode,
                                   log=logs[j])
    _raise_on_failure(results, name)
    return results


def _launch_local(argv, n_jobs, *, log_dir, name, max_parallel, env, cwd):
    cmds = [_substitute(argv, j, n_jobs) for j in range(n_jobs)]
    logs = [os.path.join(log_dir, f"{name}.{j}.log") for j in range(n_jobs)]
    max_parallel = max_parallel or min(n_jobs, os.cpu_count() or 1)
    return _run_popen_array(cmds, logs, max_parallel=max_parallel, env=env,
                            cwd=cwd, name=name)


def _launch_ssh(argv, n_jobs, *, log_dir, name, max_parallel, env, cwd,
                hosts, ssh_bin):
    if not hosts:
        raise ValueError("ssh backend needs a non-empty host list")
    run_dir = cwd or os.getcwd()
    cmds = []
    for j in range(n_jobs):
        remote = _substitute(argv, j, n_jobs)
        exports = " ".join(
            f"export {k}={shlex.quote(v)};" for k, v in (env or {}).items()
        )
        script = (f"cd {shlex.quote(run_dir)} && {exports} "
                  f"exec {' '.join(map(shlex.quote, remote))}")
        cmds.append([ssh_bin, hosts[j % len(hosts)], script])
    logs = [os.path.join(log_dir, f"{name}.{j}.log") for j in range(n_jobs)]
    # ssh carries env inside the script; the local ssh client keeps ours
    return _run_popen_array(cmds, logs, max_parallel=max_parallel or n_jobs,
                            env=None, cwd=None, name=name)


def _launch_slurm(argv, n_jobs, *, log_dir, name, max_parallel, env, cwd,
                  sbatch_bin, sbatch_args):
    run_dir = cwd or os.getcwd()
    # {job} becomes $SLURM_ARRAY_TASK_ID inside the generated script
    words = []
    for a in argv:
        a = str(a).replace("{n_jobs}", str(n_jobs))
        if "{job}" in a:
            # double-quote (not shlex single-quote) so the injected
            # $SLURM_ARRAY_TASK_ID still expands
            esc = (a.replace("\\", "\\\\").replace('"', '\\"')
                   .replace("$", "\\$").replace("`", "\\`"))
            words.append('"' + esc.replace("{job}",
                                           "${SLURM_ARRAY_TASK_ID}") + '"')
        else:
            words.append(shlex.quote(a))
    exports = "\n".join(
        f"export {k}={shlex.quote(v)}" for k, v in (env or {}).items()
    )
    script_path = os.path.join(log_dir, f"{name}.sbatch.sh")
    log_pattern = os.path.join(log_dir, f"{name}.%a.log")
    with open(script_path, "w") as f:
        f.write("#!/bin/bash\n"
                f"#SBATCH --job-name={name}\n"
                f"#SBATCH --output={log_pattern}\n"
                f"#SBATCH --array=0-{n_jobs - 1}"
                + (f"%{max_parallel}" if max_parallel else "") + "\n"
                f"cd {shlex.quote(run_dir)}\n"
                f"{exports}\n"
                f"exec {' '.join(words)}\n")
    submit = [sbatch_bin, "--wait", *sbatch_args, script_path]
    proc = subprocess.run(submit, capture_output=True, text=True)
    results = [
        JobResult(job=j, returncode=proc.returncode,
                  log=os.path.join(log_dir, f"{name}.{j}.log"))
        for j in range(n_jobs)
    ]
    if proc.returncode != 0:
        raise RuntimeError(
            f"sbatch --wait failed (rc {proc.returncode}) for '{name}':\n"
            f"{proc.stdout}\n{proc.stderr}\n"
            f"job logs: {os.path.join(log_dir, name + '.*.log')}"
        )
    return results


def _launch_sge(argv, n_jobs, *, log_dir, name, max_parallel, env, cwd,
                qsub_bin, qsub_args):
    run_dir = cwd or os.getcwd()
    # {job} becomes the 0-based $JOB derived from 1-based $SGE_TASK_ID
    words = []
    for a in argv:
        a = str(a).replace("{n_jobs}", str(n_jobs))
        if "{job}" in a:
            esc = (a.replace("\\", "\\\\").replace('"', '\\"')
                   .replace("$", "\\$").replace("`", "\\`"))
            words.append('"' + esc.replace("{job}", "${JOB}") + '"')
        else:
            words.append(shlex.quote(a))
    exports = "\n".join(
        f"export {k}={shlex.quote(v)}" for k, v in (env or {}).items()
    )
    script_path = os.path.join(log_dir, f"{name}.qsub.sh")
    log_base = os.path.join(log_dir, name)
    with open(script_path, "w") as f:
        # header mirrors queue.pl's default qsub template (-cwd -S /bin/bash
        # -j y); stdout/stderr self-redirect to the per-job
        # log so naming matches the other backends, with qsub's own streams
        # parked in log_dir as a fallback for pre-exec failures.
        f.write("#!/bin/bash\n"
                f"#$ -N {name}\n"
                "#$ -cwd\n"
                "#$ -S /bin/bash\n"
                "#$ -j y\n"
                f"#$ -o {log_dir}\n"
                "JOB=$((SGE_TASK_ID - 1))\n"
                f"exec > {shlex.quote(log_base)}.${{JOB}}.log 2>&1\n"
                f"cd {shlex.quote(run_dir)}\n"
                f"{exports}\n"
                f"exec {' '.join(words)}\n")
    submit = [qsub_bin, "-terse", "-sync", "y", "-t", f"1-{n_jobs}"]
    if max_parallel:
        submit += ["-tc", str(max_parallel)]
    submit += [*qsub_args, script_path]
    proc = subprocess.run(submit, capture_output=True, text=True)
    results = [
        JobResult(job=j, returncode=proc.returncode,
                  log=f"{log_base}.{j}.log")
        for j in range(n_jobs)
    ]
    if proc.returncode != 0:
        # -sync y exits nonzero if any task failed; surface the first log
        # tail like run.pl does
        tails = "\n".join(
            f"--- {r.log} tail ---\n{_tail(r.log)}" for r in results[:1]
        )
        raise RuntimeError(
            f"qsub -sync y failed (rc {proc.returncode}) for '{name}':\n"
            f"{proc.stdout}\n{proc.stderr}\n{tails}"
        )
    return results


def launch(argv: Sequence[str], n_jobs: int, *, backend: str = "local",
           log_dir: str, name: str = "job",
           max_parallel: Optional[int] = None,
           env: Optional[dict] = None, cwd: Optional[str] = None,
           hosts: Optional[Sequence[str]] = None, ssh_bin: str = "ssh",
           sbatch_bin: str = "sbatch",
           sbatch_args: Sequence[str] = (),
           qsub_bin: str = "qsub",
           qsub_args: Sequence[str] = ()) -> list:
    """Run ``argv`` as an n_jobs array; block until all jobs finish.

    ``{job}``/``{n_jobs}`` placeholders in argv elements are substituted per
    job. Returns a list of JobResult; raises RuntimeError (with the first
    failing log's tail) if any job fails — the run.pl contract.

    ``env`` semantics: local jobs inherit the parent environment overlaid
    with ``env``; ssh/slurm jobs get ``env`` exported inside the remote
    script (the remote login environment underneath).
    """
    if n_jobs < 1:
        raise ValueError("n_jobs must be >= 1")
    os.makedirs(log_dir, exist_ok=True)
    if backend == "local":
        full_env = dict(os.environ, **(env or {}))
        return _launch_local(argv, n_jobs, log_dir=log_dir, name=name,
                             max_parallel=max_parallel, env=full_env, cwd=cwd)
    if backend == "ssh":
        return _launch_ssh(argv, n_jobs, log_dir=log_dir, name=name,
                           max_parallel=max_parallel, env=env, cwd=cwd,
                           hosts=hosts, ssh_bin=ssh_bin)
    if backend == "slurm":
        return _launch_slurm(argv, n_jobs, log_dir=log_dir, name=name,
                             max_parallel=max_parallel, env=env, cwd=cwd,
                             sbatch_bin=sbatch_bin, sbatch_args=sbatch_args)
    if backend == "sge":
        return _launch_sge(argv, n_jobs, log_dir=log_dir, name=name,
                           max_parallel=max_parallel, env=env, cwd=cwd,
                           qsub_bin=qsub_bin, qsub_args=qsub_args)
    raise ValueError(f"unknown launcher backend: {backend!r} "
                     "(expected local | ssh | slurm | sge)")
