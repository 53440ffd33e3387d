"""PyTorch + CUDA port of svcc23_fastsvc_tpu for NVIDIA Hopper (H100).

The JAX package `svcc23_fastsvc_tpu` is the reference this package is tested
against; nothing here imports it or JAX. It holds the FastSVC recipe's
conversion (decode) and GAN training paths: `bin.decode_fastsvc` and
`bin.train_fastsvc` drive `models.fastsvc` (the generator and the MelGAN
multi-scale discriminator) and `ops.signal_gen.SignalGenerator`. The
generator's K=3 convs (forward, input gradient, weight gradient) and the
sine excitation run as hand-written CUDA kernels (`csrc/`, built by
`ops._build`). Entry points run on `cuda` unless the caller passes
`device="cpu"`; on CPU tensors the kernels' plain PyTorch versions run.
"""
