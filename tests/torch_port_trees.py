"""Small DeepFashion- and Market-layout trees for the port's data tests,
written with PIL and the csv module."""

import csv
import os

import numpy as np
from PIL import Image


def write_tree(root, prefix, n_images=8, size=(64, 44), pairs=12,
               old_size=(256, 176), seed=0):
    """A `{prefix}` tree (fasion or market) of seeded JPEGs, keypoints at
    `old_size` (a fifth missing) and random same-phase pairs, train and
    test."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size[0], :size[1]]
    for phase in ("train", "test"):
        os.makedirs(os.path.join(root, phase), exist_ok=True)
        names, rows = [], []
        for i in range(n_images):
            name = f"{phase}{i:02d}.jpg"
            img = np.stack([(yy * 4 + i * 20) % 256, (xx * 5) % 256,
                            rng.randint(0, 256, size)], -1).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, phase, name))
            kp = np.stack([rng.randint(0, old_size[0], 18),
                           rng.randint(0, old_size[1], 18)], 1)
            kp[rng.rand(18) < 0.2] = -1
            names.append(name)
            rows.append([name, str(kp[:, 0].tolist()),
                         str(kp[:, 1].tolist())])
        with open(os.path.join(root, f"{prefix}-annotation-{phase}.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f, delimiter=":")
            writer.writerow(["name", "keypoints_y", "keypoints_x"])
            writer.writerows(rows)
        with open(os.path.join(root, f"{prefix}-pairs-{phase}.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["from", "to"])
            for _ in range(pairs):
                a, b = rng.choice(n_images, 2, replace=False)
                writer.writerow([names[a], names[b]])
    return str(root)
