"""dpcx_torch CLI (port of ``dpcx/cli.py``: the ``datagen``, ``train`` and
``serve`` verbs):

    python -m dpcx_torch.cli datagen -f experiments/car_64_depth.yaml -n 32
    python -m dpcx_torch.cli train   -f experiments/car_64_depth.yaml -n 32 --steps 200
    python -m dpcx_torch.cli serve   -f experiments/car_64_depth.yaml

Each prints dpcx's last JSON line. ``serve`` serves the newest port
checkpoint in ``checkpoint_dir/ckpt``, or the seeded initialisation when
there is none, like the reference; it refuses an Orbax checkpoint, which
the port cannot read.
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
    from dpcx_torch.train import train

    cfg = _load_cfg(args, validate=False)  # train() validates
    if args.steps:
        cfg = cfg.replace(max_number_of_steps=args.steps)
    _, history = train(cfg, num_models=args.num_models, device=args.device)
    if history:
        print(json.dumps(history[-1]))


def cmd_datagen(args) -> None:
    from dpcx_torch.data.dataset import load_or_make

    cfg = _load_cfg(args)
    ds = load_or_make(cfg, args.num_models, seed=cfg.seed, device=args.device)
    print(json.dumps({"models": ds.num_models, "views": ds.num_views,
                      "dir": cfg.data_dir}))


def cmd_serve(args) -> None:
    """Online inference server (dpcx_torch/serve.py)."""
    import torch

    from dpcx_torch.models.model_pc import ModelPointCloud
    from dpcx_torch.serve import serve
    from dpcx_torch.train import load_checkpoint, record_and_check_run_config

    cfg = _load_cfg(args)
    device = torch.device(args.device)
    try:
        record_and_check_run_config(cfg, write=False)
        saved = load_checkpoint(cfg, device)
    except ValueError as e:  # an Orbax checkpoint, or changed semantics
        raise SystemExit(str(e)) from e
    if saved is None:
        params = ModelPointCloud(cfg, device=device).state_dict()
    else:
        params = saved["params"]
    srv = serve(
        cfg, params, port=args.port, batch_size=args.batch,
        cast_bf16=args.bf16,
    )
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dpcx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [
        ("train", cmd_train),
        ("datagen", cmd_datagen),
        ("serve", cmd_serve),
    ]:
        sp = sub.add_parser(name)
        sp.add_argument("-f", "--config", default=None)
        sp.add_argument("-n", "--num-models", type=int, default=200)
        sp.add_argument("--steps", type=int, default=0)
        # dpcx's command lines carry -o to every verb; these ignore it
        sp.add_argument("-o", "--out", default="predictions.npz")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on")
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
