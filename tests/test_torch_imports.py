"""The port stands alone: importing every module of svcc23_fastsvc_tpu_torch
loads neither JAX nor the JAX package (checked in a fresh interpreter)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import svcc23_fastsvc_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "svcc23_fastsvc_tpu")
             or m.startswith(("jax.", "jaxlib", "svcc23_fastsvc_tpu.")))
missing = sorted({"svcc23_fastsvc_tpu_torch.ops.down_chain",
                  "svcc23_fastsvc_tpu_torch.ops.pd_block",
                  "svcc23_fastsvc_tpu_torch.ops.fused_conv",
                  "svcc23_fastsvc_tpu_torch.models.tacotron2",
                  "svcc23_fastsvc_tpu_torch.bin.decode_b02",
                  "svcc23_fastsvc_tpu_torch.bin.extract_spk_embs",
                  "svcc23_fastsvc_tpu_torch.bin.preprocess_fastsvc",
                  "svcc23_fastsvc_tpu_torch.bin.compute_f0stats",
                  "svcc23_fastsvc_tpu_torch.bin.compute_statistics_fastsvc",
                  "svcc23_fastsvc_tpu_torch.bin.normalize_fastsvc",
                  "svcc23_fastsvc_tpu_torch.dsp.harvest",
                  "svcc23_fastsvc_tpu_torch.dsp.trim",
                  "svcc23_fastsvc_tpu_torch.models.conformer_ppg",
                  "svcc23_fastsvc_tpu_torch.models.xvector",
                  "svcc23_fastsvc_tpu_torch.utils.scalers",
                  "svcc23_fastsvc_tpu_torch.dsp.world",
                  "svcc23_fastsvc_tpu_torch.models.hubert",
                  "svcc23_fastsvc_tpu_torch.bin.preprocess_b02",
                  "svcc23_fastsvc_tpu_torch.bin.compute_statistics_b02",
                  "svcc23_fastsvc_tpu_torch.bin.normalize_b02",
                  "svcc23_fastsvc_tpu_torch.bin.evaluate",
                  "svcc23_fastsvc_tpu_torch.bin.split_train_dev",
                  "svcc23_fastsvc_tpu_torch.utils.metrics",
                  "svcc23_fastsvc_tpu_torch.data.prefetch",
                  "svcc23_fastsvc_tpu_torch.data.native_batch",
                  "svcc23_fastsvc_tpu_torch.utils.host_build"} - set(names))
print(len(names), bad + missing)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 30, out.stdout
    assert bad == "[]", bad
