#!/usr/bin/env python3
"""Convert an inference artifact of the JAX package into one of the PyTorch
port.

    python3 scripts/jax_artifact_to_torch.py JAX_ARTIFACT OUT_DIR

Runs where JAX and orbax are installed (the machine that trained with the JAX
package). Reads the JAX artifact (``variables/``, an orbax checkpoint of
params and batch_stats; ``config.json``; ``projection_weight.pkl``, as the
JAX package's ``eval/export.py`` writes them) and writes the port's
``config.json`` (the same schema, with the artifact's step), ``weights.pt``
(the variables through ``convert.from_flax``) and a copy of
``projection_weight.pkl``. The port loads the result with
``eval/export.py:load_inference_artifact`` and needs no JAX to do so; the
port itself never imports this script.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(jax_dir: str, out_dir: str) -> str:
    """Write the port's artifact of ``jax_dir`` into ``out_dir``; returns it."""
    import jax
    import orbax.checkpoint as ocp

    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import save_inference_artifact

    jax_dir = os.path.abspath(jax_dir)
    cfg_path = os.path.join(jax_dir, "config.json")
    with open(cfg_path) as f:
        step = int(json.load(f).get("step", 0))
    variables = jax.device_get(
        ocp.StandardCheckpointer().restore(os.path.join(jax_dir, "variables")))
    out = save_inference_artifact(
        TrainConfig.from_json(cfg_path),
        from_flax({"params": variables["params"], "batch_stats": variables["batch_stats"]}),
        out_dir, step=step)
    rows = os.path.join(jax_dir, "projection_weight.pkl")
    if os.path.exists(rows):
        shutil.copyfile(rows, os.path.join(out, "projection_weight.pkl"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_artifact", help="the JAX package's artifact dir (cli.export output)")
    p.add_argument("out_dir", help="the port's artifact dir to write")
    args = p.parse_args(argv)
    print(f"port artifact at {convert(args.jax_artifact, args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
