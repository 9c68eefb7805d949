"""Pipeline configuration — NECAT-compatible KEY=VALUE files (the port's
copy of necat_tpu/pipeline/config.py).

Parses the reference's config keys (template at necat.pl:24-57, defaultConfig;
loadConfig Plgd/Project.pm:28-41) and maps the option strings onto our typed
options. Unknown keys are kept verbatim so reference configs load unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

CONFIG_TEMPLATE = """\
PROJECT=
ONT_READ_LIST=
GENOME_SIZE=
THREADS=4
MIN_READ_LENGTH=3000
PREP_OUTPUT_COVERAGE=40
OVLP_FAST_OPTIONS=-n 500 -z 20 -b 2000 -e 0.5 -j 0 -u 1 -a 1000
OVLP_SENSITIVE_OPTIONS=-n 500 -z 10 -e 0.5 -j 0 -u 1 -a 1000
CNS_FAST_OPTIONS=-a 2000 -x 4 -y 12 -l 1000 -e 0.5 -p 0.8 -u 0
CNS_SENSITIVE_OPTIONS=-a 2000 -x 4 -y 12 -l 1000 -e 0.5 -p 0.8 -u 0
TRIM_OVLP_OPTIONS=-n 100 -z 10 -b 2000 -e 0.5 -j 1 -u 1 -a 400
ASM_OVLP_OPTIONS=-n 100 -z 10 -b 2000 -e 0.5 -j 1 -u 0 -a 400
NUM_ITER=2
CNS_OUTPUT_COVERAGE=30
CLEANUP=1
USE_GRID=false
GRID_NODE=0
GRID_OPTIONS=
SMALL_MEMORY=0
FSA_OL_FILTER_OPTIONS=
FSA_ASSEMBLE_OPTIONS=
FSA_CTG_BRIDGE_OPTIONS=
POLISH_CONTIGS=true
"""


@dataclasses.dataclass
class Config:
    raw: Dict[str, str]

    @property
    def project(self) -> str:
        return self.raw.get("PROJECT", "necat_project")

    @property
    def read_list(self) -> str:
        return self.raw.get("ONT_READ_LIST", "")

    @property
    def genome_size(self) -> int:
        v = self.raw.get("GENOME_SIZE", "0")
        return parse_genome_size(v)

    @property
    def min_read_length(self) -> int:
        return int(self.raw.get("MIN_READ_LENGTH", "3000") or 3000)

    @property
    def prep_output_coverage(self) -> float:
        return float(self.raw.get("PREP_OUTPUT_COVERAGE", "40") or 40)

    @property
    def cns_output_coverage(self) -> float:
        return float(self.raw.get("CNS_OUTPUT_COVERAGE", "30") or 30)

    @property
    def num_iter(self) -> int:
        return int(self.raw.get("NUM_ITER", "2") or 2)

    @property
    def polish(self) -> bool:
        return self.raw.get("POLISH_CONTIGS", "true").strip().lower() in ("true", "1", "yes")

    def get(self, key: str, default: str = "") -> str:
        return self.raw.get(key, default)


def parse_genome_size(v: str) -> int:
    v = v.strip().lower()
    if not v:
        return 0
    mult = 1
    if v.endswith("k"):
        mult, v = 1000, v[:-1]
    elif v.endswith("m"):
        mult, v = 1000000, v[:-1]
    elif v.endswith("g"):
        mult, v = 1000000000, v[:-1]
    return int(float(v) * mult)


def load_config(path: str | os.PathLike) -> Config:
    raw: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                continue
            k, _, v = line.partition("=")
            raw[k.strip()] = v.strip()
    return Config(raw)


def write_template(path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        f.write(CONFIG_TEMPLATE)
