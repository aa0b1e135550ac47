"""CNN training entry point (PyTorch port of ``flexflow_tpu/apps/cnn.py``).

    python -m flexflow_tpu_torch.apps.cnn inception -b 256 -i 10 \\
        --dtype bfloat16 [--device cuda|cpu] [--warmup N]
    python -m flexflow_tpu_torch.apps.cnn densenet -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn resnet101 -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn vgg16 -b 64 -i 13 \\
        --warmup 3 --dtype bfloat16
    python -m flexflow_tpu_torch.apps.cnn alexnet -b 2 -i 3 --height 67 \\
        --width 67 --device cpu

Flags are ``FFConfig.from_args`` (the JAX app's names for the ported
fields: -b, --lr, --wd, -p, -i, --dtype, --param-dtype, --seed, --height,
--width, --classes, and ``fit``'s runtime flags --ckpt-dir, --ckpt-freq,
--prefetch-depth, --on-divergence, --max-rollbacks, --fault-spec), plus
``--device`` (default ``cuda``: the run raises
when CUDA is absent unless ``--device cpu`` is given) and ``--warmup``
(untimed steps before the timed window, default 1 as in ``fit``).  Models
(the JAX app's names): ``alexnet``, ``vgg16``/``vgg``,
``resnet101``/``resnet`` (the reference's topology: no BN, no residual
add) and ``densenet``/``densenet121`` at 224x224 unless --height/--width
are given, ``inception``/``inception_v3`` at 299x299.
The input is seeded random synthetic data (``data/synthetic.py``,
``mode="random"``).  Prints the reference's metric line
``time = %.4fs, tp = %.2f images/s``.  The JAX app's datasets,
strategies, elastic and telemetry features raise
``NotImplementedError`` when asked for (``config.UNPORTED_FLAGS``).
"""

from __future__ import annotations

import sys

import torch

from flexflow_tpu_torch.config import FFConfig

MODELS = ("alexnet", "vgg16", "vgg", "inception", "inception_v3",
          "resnet101", "resnet", "densenet", "densenet121")


def _flag_value(argv, name, default):
    """``(value, argv without the flag)`` for one flag of this app alone."""
    rest, value = [], default
    it = iter(argv)
    for a in it:
        if a == name:
            value = next(it, None)
            if value is None:
                raise ValueError(f"flag {name!r} expects a value")
        else:
            rest.append(a)
    return value, rest


def build(model_name: str, cfg: FFConfig, device):
    """The model named ``model_name`` on ``device`` (299x299 input for
    Inception unless --height/--width were given)."""
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.densenet import build_densenet121
    from flexflow_tpu_torch.models.inception import build_inception_v3
    from flexflow_tpu_torch.models.resnet import build_resnet101
    from flexflow_tpu_torch.models.vgg import build_vgg16

    if model_name == "alexnet":
        return build_alexnet(cfg, device=device)
    if model_name.startswith("vgg"):
        return build_vgg16(cfg, device=device)
    if model_name.startswith("resnet"):
        return build_resnet101(cfg, device=device)
    if model_name.startswith("densenet"):
        return build_densenet121(cfg, device=device)
    return build_inception_v3(cfg, device=device)


def parse(argv):
    """``(model_name, cfg, device, warmup)`` from the command line."""
    argv = list(argv)
    model_name = "alexnet"
    if argv and not argv[0].startswith("-"):
        model_name = argv.pop(0)
    if model_name not in MODELS:
        raise SystemExit(f"model {model_name!r} is not ported yet; choose "
                         f"from {list(MODELS)}")
    device, argv = _flag_value(argv, "--device", "cuda")
    warmup, argv = _flag_value(argv, "--warmup", "1")
    if model_name.startswith("inception"):
        argv = ["--height", "299", "--width", "299"] + argv
    cfg = FFConfig.from_args(argv)
    return model_name, cfg, device, int(warmup)


def main(argv=None, log=print) -> dict:
    """One training run; returns ``fit``'s result without the trees."""
    from flexflow_tpu_torch.data import synthetic_batches
    from flexflow_tpu_torch.machine import resolve_device

    model_name, cfg, device, warmup = parse(
        sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # float32 references run their products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ff = build(model_name, cfg, dev)
    log(f"{model_name}: {len(ff.layers)} layers, batch {cfg.batch_size}, "
        f"{cfg.input_height}x{cfg.input_width}, {cfg.compute_dtype} compute, "
        f"{cfg.param_dtype} params, on {dev}")
    data = synthetic_batches(cfg.batch_size, cfg.input_height,
                             cfg.input_width, num_classes=cfg.num_classes,
                             mode="random", seed=cfg.seed, device=dev)
    out = ff.fit(data, warmup=warmup, log=log)
    for key in ("params", "state", "opt_state"):
        out.pop(key)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
