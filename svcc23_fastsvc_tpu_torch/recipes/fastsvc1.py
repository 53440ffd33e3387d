"""The FastSVC recipe, stages 0-5, through the package's own CLIs.

Counterpart of `egs/svcc23/fastsvc1/run.py`, with its flags and its
commands (the test of the two drivers holds them equal), plus `--device`
(default cuda), which every CLI that runs on a device gets:

  stage 0: speaker embeddings        (`extract_spk_embs`, x-vector or hash)
  stage 1: feature extraction        (`preprocess_fastsvc`, train and dev;
                                      `--n-jobs N` > 1: N scp shards as one
                                      launcher job array, `--cmd` its
                                      backend)
  stage 2: per-speaker F0 statistics (`compute_f0stats`)
  stage 3: statistics, normalization (`compute_statistics_fastsvc`,
                                      `normalize_fastsvc`)
  stage 4: GAN training              (`train_fastsvc --resume`)
  stage 5: decoding                  (`decode_fastsvc` of the latest
                                      checkpoint under <expdir>/<tag>, found
                                      when the stage starts)

    python -m svcc23_fastsvc_tpu_torch.recipes.fastsvc1 --stage 0 \
        --stop-stage 5 --datadir data --dumpdir dump --expdir exp \
        [--n-jobs 8] [--device cuda]

Expects <datadir>/{train,dev}/wav.scp; reads egs/svcc23/fastsvc1/conf/
by default. Training across processes (`--n-procs` > 1) needs the
scale-out layer (the JAX package's `parallel/mesh.py` and
`parallel/distributed.py`), which is not ported yet: it raises.
"""

from __future__ import annotations

import os

from .common import Driver, base_parser, latest_pkl


def main(argv=None):
    p = base_parser("fastsvc1", "fastsvc.yaml", 5, "fastsvc",
                    ["logmel", "conformer"])
    p.add_argument("--ppg-checkpoint", default=None)
    p.add_argument("--xvector-checkpoint", default=None,
                   help="SpeechBrain embedding_model.ckpt; stage 0 extracts "
                        "real x-vectors instead of hash embeddings")
    p.add_argument("--speakers", nargs="*", default=None)
    p.add_argument("--n-procs", type=int, default=1,
                   help="training processes (only 1: scale-out is not "
                        "ported yet)")
    args = p.parse_args(argv)
    if args.n_procs > 1:
        p.error(f"--n-procs {args.n_procs}: training across processes needs "
                "the scale-out layer (parallel/mesh.py, "
                "parallel/distributed.py), which is not ported yet")
    d = Driver(args)

    train_scp = os.path.join(args.datadir, "train", "wav.scp")
    dev_scp = os.path.join(args.datadir, "dev", "wav.scp")
    spk_embs = os.path.join(args.dumpdir, "spk_embs.h5")
    exp = os.path.join(args.expdir, args.tag)

    def dump(split, norm=False):
        return os.path.join(args.dumpdir, f"{split}{'_norm' if norm else ''}")

    if d.runs(0):
        with d.stage(0):
            if args.xvector_checkpoint:
                d.sh("extract_spk_embs", "--wav-scp", train_scp,
                     "--out-file", spk_embs, "--mode", "xvector",
                     "--checkpoint", args.xvector_checkpoint)
            else:  # no pretrained weights: seeded hash embeddings
                d.sh("extract_spk_embs", "--wav-scp", train_scp,
                     "--out-file", spk_embs, "--mode", "hash")

    if d.runs(1):
        with d.stage(1):
            for split, scp in (("train", train_scp), ("dev", dev_scp)):
                if not os.path.exists(scp):
                    continue
                extra = []
                if args.linguistic == "conformer":
                    extra = ["--ppg-checkpoint", args.ppg_checkpoint]
                if os.path.exists(args.f0_conf):
                    extra += ["--f0-config", args.f0_conf]
                common = ["--wav-scp", scp, "--dumpdir", dump(split),
                          "--config", args.conf, "--spk-emb-file", spk_embs,
                          "--linguistic", args.linguistic, *extra]
                if args.n_jobs > 1:
                    d.sh_array(args.n_jobs, f"preprocess_{split}",
                               "preprocess_fastsvc", *common,
                               "--n-shards", "{n_jobs}", "--shard-id",
                               "{job}")
                else:
                    d.sh("preprocess_fastsvc", *common)

    if d.runs(2):
        with d.stage(2):
            d.sh("compute_f0stats", "--dumpdir", dump("train"),
                 "--outdir", os.path.join(args.dumpdir, "f0_stats"))

    if d.runs(3):
        with d.stage(3):
            stats = os.path.join(args.dumpdir, "stats.joblib")
            d.sh("compute_statistics_fastsvc", "--dumpdir", dump("train"),
                 "--dumpfile", stats)
            for split in ("train", "dev"):
                if os.path.isdir(dump(split)):
                    d.sh("normalize_fastsvc", "--dumpdir", dump(split),
                         "--outdir", dump(split, norm=True), "--stats",
                         stats)

    if d.runs(4):
        with d.stage(4):
            extra = []
            if os.path.isdir(dump("dev", norm=True)):
                extra = ["--dev-dumpdir", dump("dev", norm=True)]
            d.sh("train_fastsvc", "--train-dumpdir", dump("train", norm=True),
                 "--outdir", exp, "--config", args.conf, "--resume", *extra)

    if d.runs(5):
        with d.stage(5):
            extra = []
            if args.speakers:
                extra = ["--speakers", *args.speakers]
            d.sh("decode_fastsvc", "--dumpdir", dump("dev", norm=True),
                 "--checkpoint", latest_pkl(exp),
                 "--outdir", os.path.join(exp, "wav"),
                 "--f0-stats-dir", os.path.join(args.dumpdir, "f0_stats"),
                 "--spk-emb-file", spk_embs, *extra)
    d.finish()
    return d.report


if __name__ == "__main__":
    main()
