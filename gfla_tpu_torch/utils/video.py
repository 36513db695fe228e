"""A streamed test sequence's frames stitched into an mp4 (counterpart of
gfla_tpu/utils/video.py:18-43; the original's write2video,
dance_model.py:191-218): each requested stream's `*_{name}.{ext}` frames,
side by side, at 15 fps, as `{results_dir}_{names}_.mp4`.

The encoder is cv2's, imported in the function as gfla_tpu does; the port
depends on cv2 nowhere else and has no MPEG-4 encoder of its own. Where cv2
does not import, the frames stay on disk and one line says that the video
was not written (ROADMAP.md, "Left out of the port").
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np


def write2video(results_dir: str, name_list: Sequence[str],
                ext: str = "png", fps: int = 15) -> str:
    """The mp4's path, or "" when no frame was found or there is no cv2."""
    streams = [sorted(glob.glob(os.path.join(results_dir, f"*_{name}.{ext}")))
               for name in name_list]
    n = min(len(s) for s in streams)
    if n == 0:
        return ""
    try:
        import cv2
    except ImportError:
        print(f"write2video: no cv2 here, so no mp4 of {results_dir}; its "
              f"{n} frames of {', '.join(name_list)} stay on disk")
        return ""
    frames = [np.concatenate([cv2.imread(stream[i]) for stream in streams],
                             axis=1) for i in range(n)]
    h, w = frames[0].shape[:2]
    out_name = results_dir + "_" + "_".join(name_list) + "_.mp4"
    writer = cv2.VideoWriter(out_name, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    for frame in frames:
        writer.write(frame)
    writer.release()
    print(f"write video {out_name}")
    return out_name
