"""CLI: python -m horopose_tpu_torch.scripts.train --config configs/<robot>/<stage>.yaml

Port of `scripts/train.py`: the config's flags choose the pipeline, in
the order use_rootnet_with_reg_int_shared_backbone (stage 2, the full
network) > use_rootnet (stage 1, DepthNet) > use_sim2real (stage 3, not
ported yet). It trains on the card; `--device cpu` asks for the CPU.
`compute_dtype : "bfloat16"` in the config trains under bfloat16 autocast.
"""

import argparse

import torch

from horopose_tpu_torch.config import make_cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Holistic robot pose "
                                                 "estimation training")
    parser.add_argument("--config", type=str, required=True,
                        help="path to the experiment YAML")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = make_cfg(args.config)
    print(f"use config file: {args.config}")
    print(f"experiment: {cfg.exp_name}")
    dtype = torch.bfloat16 if str(cfg.compute_dtype) == "bfloat16" \
        else torch.float32
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    if cfg.use_rootnet_with_reg_int_shared_backbone:
        from horopose_tpu_torch.pipelines.train_full import train_full
        print("training with full network pipeline (regression + integral "
              "+ rootnet)")
        train_full(cfg, device=args.device, dtype=dtype)
    elif cfg.use_rootnet:
        from horopose_tpu_torch.pipelines.train_depthnet import train_depthnet
        print("training with depthnet pipeline")
        train_depthnet(cfg, device=args.device, dtype=dtype)
    elif cfg.use_sim2real:
        raise NotImplementedError(
            "use_sim2real: the self-supervised sim2real pipeline is not "
            "ported yet (ROADMAP queue 1 item 7)")
    else:
        raise ValueError("no pipeline selected by the config flags")


if __name__ == "__main__":
    main()
