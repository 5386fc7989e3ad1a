"""dpcx_torch CLI (port of ``dpcx/cli.py``: the ``datagen``, ``train``,
``eval``, ``predict``, ``serve``, ``bench`` and ``convert`` verbs):

    python -m dpcx_torch.cli datagen -f experiments/car_64_depth.yaml -n 32
    python -m dpcx_torch.cli train   -f experiments/car_64_depth.yaml -n 32 --steps 200
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dpcx_torch.cli train -f experiments/largecloud_pointshard.yaml
    python -m dpcx_torch.cli eval    -f experiments/chair_pred_pose.yaml -n 32 --all-views
    python -m dpcx_torch.cli predict -f experiments/car_64_depth.yaml -n 32 -o preds.npz
    python -m dpcx_torch.cli serve   -f experiments/car_64_depth.yaml
    python -m dpcx_torch.cli bench
    python -m dpcx_torch.cli convert -i 'renders/*.tfrecord' -o data/shard0.npz --device cpu

Each prints dpcx's last JSON line. ``eval``, ``predict`` and ``serve`` use
the newest port checkpoint in ``checkpoint_dir/ckpt``, or dpcx's init
for the seed when there is none, like the reference; they refuse an
Orbax checkpoint, which the port cannot read. ``eval`` and ``predict``
draw the held-out set at ``seed + 1``. ``convert`` needs tensorflow, so
it is a CPU tool (``--device cpu``); without tensorflow it fails on the
import, as dpcx's does.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_cfg(args, validate: bool = True):
    from dpcx_torch.config import load_config

    cfg = load_config(args.config) if args.config else load_config()
    return cfg.validate() if validate else cfg


def cmd_train(args) -> None:
    """Train on one device, or, under ``torch.distributed.run``, as one
    rank of its world (``parallel.mesh.init_from_env``: the group is made
    before the config is validated, so that ``shard_points`` counts the
    real world; ``--device cuda`` is this rank's card). Rank 0 prints the
    last record."""
    import torch.distributed as dist

    from dpcx_torch.parallel.mesh import init_from_env, rank
    from dpcx_torch.train import train

    joined = not dist.is_initialized()
    device = init_from_env(args.device)
    joined = joined and dist.is_initialized()
    try:
        cfg = _load_cfg(args, validate=False)  # train() validates
        if args.steps:
            cfg = cfg.replace(max_number_of_steps=args.steps)
        _, history = train(cfg, num_models=args.num_models, device=device)
        if history and rank() == 0:
            print(json.dumps(history[-1]))
    finally:
        if joined:
            dist.destroy_process_group()


def cmd_datagen(args) -> None:
    from dpcx_torch.data.dataset import load_or_make

    cfg = _load_cfg(args)
    ds = load_or_make(cfg, args.num_models, seed=cfg.seed, device=args.device)
    print(json.dumps({"models": ds.num_models, "views": ds.num_views,
                      "dir": cfg.data_dir}))


def _restore_params(cfg, device):
    """The newest checkpoint's params on ``device``, or the seeded
    initialisation (``create_state``'s) when there is none."""
    import torch

    from dpcx_torch.train import (
        create_state,
        load_checkpoint,
        record_and_check_run_config,
    )

    device = torch.device(device)
    try:
        record_and_check_run_config(cfg, write=False)
        saved = load_checkpoint(cfg, device)
    except ValueError as e:  # an Orbax checkpoint, or changed semantics
        raise SystemExit(str(e)) from e
    if saved is None:
        return create_state(cfg, device).params
    return saved["params"]


def cmd_eval(args) -> None:
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.predict import evaluate, evaluate_category_slices

    cfg = _load_cfg(args)
    if args.per_category and args.per_sample:
        raise SystemExit(
            "--per-sample is not supported with --per-category (the "
            "per-category table aggregates; run per-sample on one slice)"
        )
    params = _restore_params(cfg, args.device)
    ds = load_or_make(cfg, args.num_models, seed=cfg.seed + 1,  # held out
                      device=args.device)
    # --all-views sweeps every view of every model and pools them (the
    # reference's predict_eval protocol)
    view_idx = None if args.all_views else 0
    if args.per_category:
        metrics = evaluate_category_slices(
            cfg, params, ds, view_idx=view_idx,
            flip_resolve=args.flip_resolve,
        )
    else:
        metrics = evaluate(
            cfg, params, ds, view_idx=view_idx,
            flip_resolve=args.flip_resolve, per_sample=args.per_sample,
        )
    print(json.dumps(metrics))


def cmd_predict(args) -> None:
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.predict import predict_dataset

    cfg = _load_cfg(args)
    params = _restore_params(cfg, args.device)
    ds = load_or_make(cfg, args.num_models, seed=cfg.seed + 1,
                      device=args.device)
    out = predict_dataset(cfg, params, ds, out_path=args.out)
    print(json.dumps({"num_models": len(out["points"]), "out": args.out}))


def cmd_bench(args) -> None:
    """The renderer benchmark (dpcx_torch/bench.py): one JSON line; exits
    1 when a key erred or parity failed."""
    from dpcx_torch.bench import main as bench_main

    bench_main(args.device)


def cmd_serve(args) -> None:
    """Online inference server (dpcx_torch/serve.py)."""
    from dpcx_torch.serve import serve

    cfg = _load_cfg(args)
    params = _restore_params(cfg, args.device)
    srv = serve(
        cfg, params, port=args.port, batch_size=args.batch,
        cast_bf16=args.bf16,
    )
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def cmd_convert(args) -> None:
    """Reference tfrecords -> npz shards (dpcx_torch/data/convert.py)."""
    from dpcx_torch.data.convert import convert_tfrecords

    stats = convert_tfrecords(
        args.inp, args.out,
        mask_size=args.mask_size or None,
        limit=args.num_models or None,
        device=args.device,
    )
    print(json.dumps(stats))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dpcx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [
        ("train", cmd_train),
        ("eval", cmd_eval),
        ("predict", cmd_predict),
        ("datagen", cmd_datagen),
        ("serve", cmd_serve),
        ("bench", cmd_bench),
        ("convert", cmd_convert),
    ]:
        sp = sub.add_parser(name)
        sp.add_argument("-f", "--config", default=None)
        # convert has no limit by default, as dpcx's
        sp.add_argument("-n", "--num-models", type=int,
                        default=0 if name == "convert" else 200)
        sp.add_argument("--steps", type=int, default=0)
        # dpcx's command lines carry -o to every verb; predict alone reads
        # it
        sp.add_argument("-o", "--out", default="predictions.npz")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on")
        if name == "eval":
            sp.add_argument(
                "--all-views", action="store_true",
                help="evaluate every view per model (pooled), not view 0",
            )
            sp.add_argument(
                "--per-category", action="store_true",
                help="per-category metric table + mean row (joint "
                "'multi' models; reference per-ShapeNet-category table)",
            )
            sp.add_argument(
                "--flip-resolve", action="store_true",
                help="also report pose metrics after the shape-matching "
                "mirror-flip resolver (predict.resolve_pose_flips)",
            )
            sp.add_argument(
                "--per-sample", action="store_true",
                help="attach the per-sample block (angular error, "
                "object-side residual axis/angle, chamfer, view; plus "
                "per-model gauge_spread_deg with --all-views)",
            )
        if name == "convert":
            sp.add_argument("-i", "--inp", required=True,
                            help="tfrecord glob pattern")
            sp.add_argument("--mask-size", type=int, default=0)
        if name == "serve":
            sp.add_argument("--port", type=int, default=8787)
            sp.add_argument("--batch", type=int, default=16,
                            help="fixed serving batch (requests are "
                                 "padded/chunked to it)")
            sp.add_argument("--bf16", action="store_true",
                            help="cast params to bfloat16 for serving")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
