"""Timestamped logger of the port (the role of necat_tpu/utils/logging.py;
OC_LOG / plgdInfo, ontcns_aux.h:19-35)."""

import logging
import sys

logger = logging.getLogger("necat_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                                      datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
