"""The port's job-array launcher (`svcc23_fastsvc_tpu_torch/utils/
launcher.py`, the Kaldi cmd.sh backend role) on the JAX package's
launcher tests, case for case (tests/test_launcher.py).

The local backend runs real process arrays; ssh, slurm and sge are
exercised through stub executables (the same trick Kaldi recipes use to
test queue.pl offline), asserting the generated remote command, sbatch or
qsub script has the right substitution, quoting, env export, log naming
and failure contract.
"""

import os
import stat
import subprocess
import sys

import pytest

from svcc23_fastsvc_tpu_torch.utils.launcher import launch


def _write_exe(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def test_local_array_substitution_and_logs(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    results = launch(
        [sys.executable, "-c",
         "import sys,os; open(os.path.join(sys.argv[1], f'{sys.argv[2]}.of.{sys.argv[3]}'), 'w').write('ok'); print('job', sys.argv[2])",
         str(out), "{job}", "{n_jobs}"],
        n_jobs=5, backend="local", log_dir=str(tmp_path / "log"),
        name="t", max_parallel=2,
    )
    assert [r.returncode for r in results] == [0] * 5
    assert sorted(os.listdir(out)) == [f"{j}.of.5" for j in range(5)]
    for j in range(5):
        log = tmp_path / "log" / f"t.{j}.log"
        assert f"job {j}" in log.read_text()


def test_local_failure_reports_log_tail(tmp_path):
    with pytest.raises(RuntimeError) as e:
        launch(
            [sys.executable, "-c",
             "import sys; sys.exit(1 if sys.argv[1] == '2' else 0)", "{job}"],
            n_jobs=4, backend="local", log_dir=str(tmp_path), name="f",
        )
    assert "1 of 4 'f' jobs failed" in str(e.value)
    assert "job 2" in str(e.value)


def test_local_env_overlay(tmp_path):
    launch(
        [sys.executable, "-c",
         "import os; assert os.environ['SVC_TEST_FLAG'] == 'yes'"],
        n_jobs=1, backend="local", log_dir=str(tmp_path),
        env={"SVC_TEST_FLAG": "yes"},
    )


def test_ssh_backend_via_stub(tmp_path):
    """Stub `ssh` records the host then runs the remote script locally."""
    stub = tmp_path / "ssh"
    _write_exe(stub, "#!/bin/bash\n"
                     f"echo \"$1\" >> {tmp_path}/hosts.txt\n"
                     "shift\nexec bash -c \"$1\"\n")
    out = tmp_path / "out"
    out.mkdir()
    launch(
        [sys.executable, "-c",
         "import sys,os,pathlib; pathlib.Path(sys.argv[1], sys.argv[2]).write_text(os.environ.get('SVC_ROLE',''))",
         str(out), "{job}"],
        n_jobs=4, backend="ssh", hosts=["hostA", "hostB"],
        ssh_bin=str(stub), log_dir=str(tmp_path / "log"), name="s",
        env={"SVC_ROLE": "worker"},
    )
    hosts = (tmp_path / "hosts.txt").read_text().split()
    assert sorted(hosts) == ["hostA", "hostA", "hostB", "hostB"]  # round-robin
    for j in range(4):
        assert (out / str(j)).read_text() == "worker"  # env exported remotely


def test_slurm_backend_via_stub(tmp_path):
    """Stub `sbatch --wait` parses the array range from the generated script
    and runs every task locally with SLURM_ARRAY_TASK_ID set."""
    stub = tmp_path / "sbatch"
    _write_exe(stub, r"""#!/bin/bash
script="${@: -1}"
range=$(grep -oP '(?<=--array=)\d+-\d+' "$script")
lo=${range%-*}; hi=${range#*-}
for i in $(seq $lo $hi); do
  SLURM_ARRAY_TASK_ID=$i bash "$script" || exit 1
done
""")
    out = tmp_path / "out"
    out.mkdir()
    results = launch(
        [sys.executable, "-c",
         "import sys,pathlib; pathlib.Path(sys.argv[1], sys.argv[2]).write_text('ok')",
         str(out), "{job}"],
        n_jobs=3, backend="slurm", sbatch_bin=str(stub),
        log_dir=str(tmp_path / "log"), name="sl",
    )
    assert len(results) == 3
    assert sorted(os.listdir(out)) == ["0", "1", "2"]
    script = (tmp_path / "log" / "sl.sbatch.sh").read_text()
    assert "--array=0-2" in script
    assert "${SLURM_ARRAY_TASK_ID}" in script


def test_unknown_backend(tmp_path):
    with pytest.raises(ValueError):
        launch(["true"], 1, backend="mpi", log_dir=str(tmp_path))

def test_sge_backend_via_stub(tmp_path):
    """Stub `qsub -sync y -t 1-N` parses the task range from its args and
    runs every task locally with the 1-based SGE_TASK_ID set (queue.pl's
    contract)."""
    stub = tmp_path / "qsub"
    _write_exe(stub, r"""#!/bin/bash
range=""
while [ $# -gt 1 ]; do
  case "$1" in
    -t) range="$2"; shift 2 ;;
    -sync|-tc) shift 2 ;;
    -terse) shift ;;
    *) shift ;;
  esac
done
script="$1"
lo=${range%-*}; hi=${range#*-}
for i in $(seq $lo $hi); do
  SGE_TASK_ID=$i bash "$script" || exit 1
done
""")
    out = tmp_path / "out"
    out.mkdir()
    results = launch(
        [sys.executable, "-c",
         "import sys,pathlib; pathlib.Path(sys.argv[1], sys.argv[2]).write_text('ok'); print('ran', sys.argv[2])",
         str(out), "{job}"],
        n_jobs=3, backend="sge", qsub_bin=str(stub),
        log_dir=str(tmp_path / "log"), name="q", max_parallel=2,
        env={"MYVAR": "a b"},
    )
    assert len(results) == 3
    # SGE_TASK_ID 1..3 mapped to 0-based {job}
    assert sorted(os.listdir(out)) == ["0", "1", "2"]
    script = (tmp_path / "log" / "q.qsub.sh").read_text()
    assert "SGE_TASK_ID - 1" in script
    assert "export MYVAR='a b'" in script
    for j in range(3):
        log = tmp_path / "log" / f"q.{j}.log"
        assert f"ran {j}" in log.read_text()


def test_sge_backend_failure_contract(tmp_path):
    stub = tmp_path / "qsub"
    _write_exe(stub, "#!/bin/bash\nexit 1\n")
    with pytest.raises(RuntimeError, match="qsub -sync y failed"):
        launch(
            ["true"], n_jobs=2, backend="sge", qsub_bin=str(stub),
            log_dir=str(tmp_path / "log"), name="qf",
        )
