"""The correct command on a list of devices writes what it writes on one."""

import gzip
import json

from necat_tpu_torch.pipeline import cli
from necat_tpu_torch.utils import shapes
from torch_port_helpers import indel_store


def test_cli_correct_on_devices_matches_one_device(tmp_path, monkeypatch):
    """`cli correct --device cpu,cpu` (two iterations, the second with the
    rescue ladder, capped at 512) writes the cns_final content and the
    manifest's pairs per band of `--device cpu`, and records its devices."""
    monkeypatch.setattr(shapes, "MAX_BAND", 512)
    reads = tmp_path / "reads.fasta"
    indel_store(4000, 33, 34)[1].to_fasta(reads)
    (tmp_path / "read_list.txt").write_text(f"{reads}\n")
    done = {}
    for name, device in (("one", "cpu"), ("two", "cpu,cpu")):
        cfg = tmp_path / f"{name}.cfg"
        cfg.write_text(
            f"PROJECT={tmp_path / name}\nONT_READ_LIST={tmp_path / 'read_list.txt'}\n"
            "GENOME_SIZE=4000\nMIN_READ_LENGTH=1000\nPREP_OUTPUT_COVERAGE=40\n"
            "CNS_OUTPUT_COVERAGE=4\nNUM_ITER=2\nOVLP_SENSITIVE_OPTIONS=-k 13\n"
            "OVLP_FAST_OPTIONS=-k 13\n")
        assert cli.main(["correct", str(cfg), "--device", device]) == 0
        done[name] = json.loads((tmp_path / name / "1-consensus" / "correct.done.json")
                                .read_text())
    content = [gzip.open(tmp_path / n / "1-consensus" / "cns_final.fasta.gz").read()
               for n in ("one", "two")]
    assert content[0] == content[1] and content[0].count(b">") >= 3
    assert done["one"]["devices"] == ["cpu"] and done["two"]["devices"] == ["cpu", "cpu"]
    pairs = {n: [it["pairs_by_band"] for it in d["iterations"]] for n, d in done.items()}
    assert pairs["one"] == pairs["two"] and pairs["one"][0]["128"] > 0
    assert [len(it["index_build_s"]) for it in done["two"]["iterations"]] == [2, 2]
