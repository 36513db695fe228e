"""The trainer's record (counterpart of gfla_tpu/utils/visualizer.py, the
reference's util/visualizer.py): loss lines printed and appended to
`loss_log.txt`, held-out evaluation lines to `eval_log.txt`, both in
gfla_tpu's formats, and visuals as `web/images/iter{N:08d}_{label}.png`
with an HTML index. The PNGs go through the port's own writer
(data/image_io.write_png), so this runs where no image library is
installed. gfla_tpu's optional TensorBoard writer is not ported. In a
data-parallel run only rank 0 records; on the other ranks every method
does nothing."""

from __future__ import annotations

import os
import time
from typing import Dict

from gfla_tpu_torch import parallel
from gfla_tpu_torch.data.image_io import write_png


class Visualizer:
    def __init__(self, opt):
        self.enabled = parallel.is_main()
        if not self.enabled:
            return
        self.name = opt.name
        self.log_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_name = os.path.join(self.log_dir, "loss_log.txt")
        self.eval_log_name = os.path.join(self.log_dir, "eval_log.txt")
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) "
                    "================\n")
        self.use_html = not getattr(opt, "no_html", False)
        self.win_size = getattr(opt, "display_winsize", 256)
        self.web_dir = os.path.join(self.log_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        if self.use_html:
            os.makedirs(self.img_dir, exist_ok=True)

    def print_current_errors(self, epoch: int, iters: int,
                             errors: Dict[str, float], t: float):
        if not self.enabled:
            return
        message = f"(epoch: {epoch}, iters: {iters}, time: {t:.3f}) "
        for k, v in errors.items():
            message += f"{k}: {float(v):.3f} "
        print(message, flush=True)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def print_current_eval(self, epoch: int, iters: int,
                           eval_results: Dict[str, float]):
        if not self.enabled:
            return
        message = f"(epoch: {epoch}, iters: {iters}) "
        for k, v in eval_results.items():
            message += f"{k}: {float(v):.5f} "
        print(message, flush=True)
        with open(self.eval_log_name, "a") as f:
            f.write(message + "\n")

    def display_current_results(self, visuals: Dict, iters: int):
        """Write each uint8 (H, W, 3) visual as a PNG and refresh the
        gallery (nothing with --no_html)."""
        if not (self.enabled and self.use_html):
            return
        for label, img in visuals.items():
            write_png(os.path.join(self.img_dir,
                                   f"iter{iters:08d}_{label}.png"), img)
        imgs = sorted(os.listdir(self.img_dir), reverse=True)[:200]
        rows = "\n".join(
            f'<div style="display:inline-block;margin:4px;text-align:center">'
            f'<img src="images/{p}" width="{self.win_size}"><br>{p}</div>'
            for p in imgs)
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(f"<html><head><title>{self.name}</title></head>"
                    f"<body><h1>{self.name}</h1>{rows}</body></html>")
