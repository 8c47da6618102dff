"""mmf_predict: prediction reports.

Port of ``mmf_tpu/cli/predict.py``: ``run(predict=True)`` with
``evaluation.predict=true``.
"""

from __future__ import annotations

import sys
import typing

from mmf_tpu_torch.cli.run import run


def predict(opts: typing.Optional[typing.List[str]] = None):
    if opts is None:
        sys.argv.extend(["evaluation.predict=true"])
    else:
        opts = list(opts) + ["evaluation.predict=true"]
    return run(predict=True, opts=opts)


if __name__ == "__main__":
    predict()
