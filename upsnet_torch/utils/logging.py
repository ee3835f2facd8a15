"""Logger factory + averaged meters (the port's copy of
``upsnet_tpu/utils/logging.py``).

Reference behavior: ``lib/utils/logging.py::create_logger`` writes to a file
under ``output/<cfg>/...`` and to the console; training prints averaged
per-loss meters every ``config.train.display_iter`` iterations
(SURVEY.md §5.5).
"""

from __future__ import annotations

import logging
import os
import time


def create_logger(output_path: str, cfg_name: str, phase: str = "train") -> logging.Logger:
    os.makedirs(output_path, exist_ok=True)
    log_file = os.path.join(
        output_path, f"{cfg_name}_{phase}_{time.strftime('%Y%m%d%H%M%S')}.log"
    )
    logger = logging.getLogger(f"upsnet_torch.{cfg_name}.{phase}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class AverageMeter:
    """Running average of a scalar (loss meters in the reference train loop)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class SpeedMeter:
    """Images/sec meter with a warmup skip (for benchmark-mode timing)."""

    def __init__(self, skip: int = 2) -> None:
        self.skip = skip
        self.seen = 0
        self.images = 0
        self.start = None

    def tick(self, batch_images: int) -> None:
        self.seen += 1
        if self.seen == self.skip:
            self.start = time.perf_counter()
            self.images = 0
        elif self.seen > self.skip:
            self.images += batch_images

    @property
    def images_per_sec(self) -> float:
        if self.start is None or self.images == 0:
            return 0.0
        return self.images / (time.perf_counter() - self.start)
