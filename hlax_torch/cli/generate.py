"""Data-generation CLI: Heterogeneous Health-MNIST (port of
``hlax/cli/generate.py``).

    python -m hlax_torch.cli.generate --destination ./data \
        --datatype_config D4 --splits prediction,test,validation

Same flags as hlax.  ``--splits`` writes ``<split>_data_<cfg>.csv``,
``<split>_label.csv``, ``<split>_mask.csv`` and the shared
``data_types_<cfg>.csv`` -- the file names of the canonical config -- with
seed ``--seed + i`` for the i-th split, as hlax does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hlax_torch.data import generate as gen


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(
        description="Enter configuration for generating data")
    p.add_argument("--source", type=str, default="",
                   help="Path to MNIST image root (optional; synthetic glyphs "
                        "are drawn when absent)")
    p.add_argument("--destination", type=str, default="./data")
    p.add_argument("--num_3", type=int, default=100)
    p.add_argument("--num_6", type=int, default=100)
    p.add_argument("--missing", type=float, default=25)
    p.add_argument("--data_file_name", type=str, default="health_MNIST_data.csv")
    p.add_argument("--data_masked_file_name", type=str,
                   default="health_MNIST_data_masked.csv")
    p.add_argument("--labels_file_name", type=str, default="health_MNIST_label.csv")
    p.add_argument("--mask_file_name", type=str, default="mask.csv")
    p.add_argument("--datatype_config", type=str, default="D1",
                   choices=["D1", "D2", "D3", "D4", "D5"])
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--splits", type=str, default="",
                   help="comma list like 'train,test,validation,prediction': "
                        "writes <split>_data_<cfg>.csv etc. for the canonical "
                        "config in one run")
    return vars(p.parse_args(argv))


def write_splits(dest: str, splits, num_3: int, num_6: int, missing: float,
                 datatype_config: str, seed: int, source: str = "") -> None:
    """The canonical config's files for each split, seed + i for split i."""
    for i, split in enumerate(splits):
        out = gen.generate(num_3, num_6, missing, datatype_config, seed + i,
                           source or None)
        gen.write_csvs(out, dest, datatype_config, prefix=f"{split}_")
        os.replace(os.path.join(dest, f"{split}_data.csv"),
                   os.path.join(dest, f"{split}_data_{datatype_config}.csv"))
        os.replace(os.path.join(dest, f"{split}_labels.csv"),
                   os.path.join(dest, f"{split}_label.csv"))
        print(f"Saved split {split}: {out['data'].shape[0]} samples")


def main(argv=None):
    opt = parse_arguments(argv)
    for key in opt:
        print(f"{key}: {opt[key]}")
    dest = opt["destination"]
    os.makedirs(dest, exist_ok=True)
    cfgname = opt["datatype_config"]

    if opt["splits"]:
        write_splits(dest, [s.strip() for s in opt["splits"].split(",")],
                     opt["num_3"], opt["num_6"], opt["missing"], cfgname,
                     opt["seed"], opt["source"])
        return

    out = gen.generate(opt["num_3"], opt["num_6"], opt["missing"],
                       cfgname, opt["seed"], opt["source"] or None)
    np.savetxt(os.path.join(dest, opt["data_file_name"]), out["data"],
               fmt="%d", delimiter=",")
    np.savetxt(os.path.join(dest, opt["mask_file_name"]), out["mask"],
               fmt="%d", delimiter=",")
    np.savetxt(os.path.join(dest, opt["data_masked_file_name"]),
               out["masked_data"], fmt="%d", delimiter=",")
    with open(os.path.join(dest, opt["labels_file_name"]), "w") as f:
        f.write(",".join(gen.LABEL_COLUMNS) + "\n")
        for row in out["labels"]:
            f.write(",".join("nan" if np.isnan(v) else f"{v:.6g}"
                             for v in row) + "\n")
    print(f"Saved! Number of samples: {out['data'].shape[0]}")


if __name__ == "__main__":
    main()
