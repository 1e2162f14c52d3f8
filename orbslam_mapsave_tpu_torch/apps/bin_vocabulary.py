"""Vocabulary converter tool — `tools/bin_vocabulary.cc` parity.

Port of `orbslam_mapsave_tpu/apps/bin_vocabulary.py`. The reference converts
the text ORB vocabulary to the ~10x-faster binary format and prints load /
save wall-times (`tools/bin_vocabulary.cc:6-52`). Also trains a fresh
vocabulary from a dataset's ORB descriptors, extracted on `--device`
(default the CUDA card; `--device cpu` runs the plain PyTorch path). Either
package reads the files the other writes.

    python -m orbslam_mapsave_tpu_torch.apps.bin_vocabulary ORBvoc.txt ORBvoc.bin
    python -m orbslam_mapsave_tpu_torch.apps.bin_vocabulary --train DATASET out.bin
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="input .txt/.bin vocabulary, or dataset root with --train")
    ap.add_argument("dst", help="output .bin/.txt vocabulary")
    ap.add_argument("--train", action="store_true",
                    help="treat src as a dataset; train a vocabulary from it")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=3)
    ap.add_argument("--max-frames", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ORB extraction (default cuda)")
    args = ap.parse_args(argv)

    from ..vocab import vocabulary as voc_mod

    if args.train:
        import numpy as np
        import torch

        from ..io import dataset as ds_mod
        from ..ops import orb

        ds = ds_mod.open_dataset(args.src)
        _, gray, _ = ds[0]
        spec = orb.ORBSpec.create(gray.shape[0], gray.shape[1],
                                  n_features=1000, max_kp=1024)
        dev = torch.device(args.device)
        descs = []
        for i in range(0, len(ds), max(1, len(ds) // args.max_frames)):
            _, gray, _ = ds[i]
            kp = orb.extract(spec, torch.as_tensor(gray).to(dev, torch.float32))
            descs.append(kp["desc"][kp["valid"]].cpu().numpy())
        all_desc = np.concatenate(descs)
        print(f"training on {len(all_desc)} descriptors (k={args.k}, L={args.L})")
        t0 = time.time()
        voc = voc_mod.train(all_desc, k=args.k, L=args.L)
        print(f"trained {voc.n_words}-word vocabulary in {time.time() - t0:.2f}s")
    else:
        t0 = time.time()
        voc = voc_mod.load(args.src)
        print(f"load time: {time.time() - t0:.4f}s ({voc.n_words} words)")

    t0 = time.time()
    if args.dst.endswith(".bin"):
        voc_mod.save_binary(args.dst, voc)
    else:
        voc_mod.save_text(args.dst, voc)
    print(f"save time: {time.time() - t0:.4f}s -> {args.dst}")
    return voc


if __name__ == "__main__":
    main()
