"""The training cell at another resolution: ``entries/train.py`` on a copy
of the cell's configuration whose ``data.image_size`` is the traffic's
``image_size`` (the same U-Net at its published widths over larger images;
its attention sites grow with the grid).

Params: ``image_size``, and ``entries/train.py``'s.
"""

from __future__ import annotations

import copy

from benchmark.entries import train

CONTROLS = train.CONTROLS
judge = train.judge


def run(run) -> None:
    run.config = copy.deepcopy(run.config)
    run.config["program"]["data"]["image_size"] = int(run.params["image_size"])
    train.run(run)
