"""The B02 recipe, stages 0-5 and 7, through the package's own CLIs.

Counterpart of `egs/svcc23/baseline02/run.py`, with its flags and its
commands (the test of the two drivers holds them equal), plus `--device`
(default cuda), which every CLI that runs on a device gets:

  stage 0: speaker embeddings (`extract_spk_embs`, hash)
  stage 1: feature extraction (`preprocess_b02`: linguistic units and
           WORLD analysis, train and dev; `--n-jobs N` > 1: N scp shards
           as one launcher job array, `--cmd` its backend)
  stage 2: statistics         (`compute_statistics_b02`)
  stage 3: normalization      (`normalize_b02`)
  stage 4: Tacotron2 training (`train_b02 --resume`)
  stage 5: decoding           (`decode_b02` of the latest checkpoint under
           <expdir>/<tag>, found when the stage starts: converted feature
           bundles)
  stage 7: vocoding           (`synthesize_b02` of the latest `.pkl` under
           `--vocoder-dir`, its config.yml beside it; runs only where a
           vocoder is given, since neither package trains one)

    python -m svcc23_fastsvc_tpu_torch.recipes.baseline02 --stage 0 \
        --stop-stage 7 --datadir data --dumpdir dump --expdir exp \
        --vocoder-dir voc --speakers IDM1 [--n-jobs 8] [--device cuda]

Expects <datadir>/{train,dev}/wav.scp; reads egs/svcc23/baseline02/conf/
by default.
"""

from __future__ import annotations

import os

from .common import EGS, Driver, base_parser, latest_pkl


def main(argv=None):
    p = base_parser("baseline02", "taco2.yaml", 7, "taco2",
                    ["logmel", "hubert"])
    p.add_argument("--hubert-checkpoint", default=None)
    p.add_argument("--vocoder-dir", default=None)
    p.add_argument("--f0-stats",
                   default=os.path.join(EGS, "baseline02", "conf", "f0.yml"),
                   help="per-speaker yaml with lf0_mean/lf0_scale (the "
                        "shipped conf/f0.yml carries both the Harvest "
                        "ranges and the conversion stats)")
    p.add_argument("--speakers", nargs="*", default=["IDM1"])
    args = p.parse_args(argv)
    d = Driver(args)

    train_scp = os.path.join(args.datadir, "train", "wav.scp")
    dev_scp = os.path.join(args.datadir, "dev", "wav.scp")
    spk_embs = os.path.join(args.dumpdir, "spk_embs.h5")
    exp = os.path.join(args.expdir, args.tag)

    def dump(split, norm=False):
        return os.path.join(args.dumpdir, f"{split}{'_norm' if norm else ''}")

    if d.runs(0):
        with d.stage(0):
            d.sh("extract_spk_embs", "--wav-scp", train_scp, "--out-file",
                 spk_embs, "--mode", "hash")

    if d.runs(1):
        with d.stage(1):
            for split, scp in (("train", train_scp), ("dev", dev_scp)):
                if not os.path.exists(scp):
                    continue
                extra = []
                if args.linguistic == "hubert":
                    extra = ["--hubert-checkpoint", args.hubert_checkpoint]
                if os.path.exists(args.f0_conf):
                    extra += ["--f0-config", args.f0_conf]
                common = ["--wav-scp", scp, "--dumpdir", dump(split),
                          "--config", args.conf, "--spk-emb-file", spk_embs,
                          "--linguistic", args.linguistic, *extra]
                if args.n_jobs > 1:
                    d.sh_array(args.n_jobs, f"preprocess_{split}",
                               "preprocess_b02", *common,
                               "--n-shards", "{n_jobs}", "--shard-id",
                               "{job}")
                else:
                    d.sh("preprocess_b02", *common)

    stats = os.path.join(args.dumpdir, "stats_b02.joblib")
    if d.runs(2):
        with d.stage(2):
            d.sh("compute_statistics_b02", "--dumpdir", dump("train"),
                 "--dumpfile", stats)

    if d.runs(3):
        with d.stage(3):
            for split in ("train", "dev"):
                if os.path.isdir(dump(split)):
                    d.sh("normalize_b02", "--dumpdir", dump(split),
                         "--outdir", dump(split, norm=True), "--stats",
                         stats)

    if d.runs(4):
        with d.stage(4):
            extra = []
            if os.path.isdir(dump("dev", norm=True)):
                extra = ["--dev-dumpdir", dump("dev", norm=True)]
            d.sh("train_b02", "--train-dumpdir", dump("train", norm=True),
                 "--outdir", exp, "--config", args.conf, "--resume", *extra)

    if d.runs(5):
        with d.stage(5):
            d.sh("decode_b02", "--dumpdir", dump("dev", norm=True),
                 "--checkpoint", latest_pkl(exp),
                 "--outdir", os.path.join(exp, "decoded"),
                 "--spk-emb-file", spk_embs,
                 "--f0-stats", args.f0_stats,
                 "--speakers", *args.speakers)

    if d.runs(7) and args.vocoder_dir:
        with d.stage(7):
            d.sh("synthesize_b02", "--dumpdir", os.path.join(exp, "decoded"),
                 "--outdir", os.path.join(exp, "wav"),
                 "--checkpoint", latest_pkl(args.vocoder_dir))
    d.finish()
    return d.report


if __name__ == "__main__":
    main()
