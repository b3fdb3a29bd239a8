"""CLI: python -m horopose_tpu_torch.scripts.test --exp_path experiments/<exp> --dataset <path or name>

Port of `scripts/test.py`, with its flags: evaluate an experiment's
checkpoint on a DREAM test set and append `<exp_path>/result/summary.txt`.
It evaluates on the card; `--device cpu` asks for the CPU.
"""

import argparse
import os

from horopose_tpu_torch.config import LOCAL_DATA_DIR
from horopose_tpu_torch.pipelines.test import make_test_cfg, test_network


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_path", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True,
                        help="test set path, or a DREAM set name under the "
                             "data dir (e.g. panda_synth_test_photo)")
    parser.add_argument("--ckpt", type=str,
                        default="curr_best_auc(add)_model.pk")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--visualization", action="store_true",
                        help="save best/worst-case skeleton figures")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on (default: cuda)")
    args = parser.parse_args(argv)

    dataset = args.dataset
    if not os.path.isdir(dataset):
        for sub in ("synthetic", "real"):
            cand = os.path.join(str(LOCAL_DATA_DIR), "dream", sub, dataset)
            if os.path.isdir(cand):
                dataset = cand
                break
    cfg = make_test_cfg(args.exp_path, dataset)
    test_network(cfg, ckpt_name=args.ckpt, batch_size=args.batch_size,
                 visualization=args.visualization, device=args.device)


if __name__ == "__main__":
    main()
