"""The port's peak tables (``ps_tpu_torch/utils/chips.py``) against the
reference's (``ps_tpu/utils/chips.py``), and ``chip_smoke.py``'s bounds
read from them by the card's name.

- The three H100 names map to their own rows: the narrower "pcie" and
  "nvl" rows are matched before the bare "h100".
- The reference's TPU ``device_kind`` strings give the reference's
  numbers, as a string or on an object with ``device_kind``.
- An unknown card gives None; ``chip_smoke._card_peaks`` raises naming it.
- The H100 SXM's peaks are bitwise the constants the smoke script held
  before, so its printed bounds do not move.
"""

import types

import pytest

from ps_tpu_torch.utils import chips

H100 = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
    "NVIDIA H100 PCIe": (756.0, 2000.0),
    "NVIDIA H100 NVL": (835.0, 3900.0),
}
TPU_KINDS = ("TPU v2", "TPU v3", "TPU v4", "TPU v5 lite", "TPU v5e",
             "TPU v5p", "TPU v6e", "TPU v6 lite")
UNKNOWN = ("NVIDIA A100-SXM4-80GB", "NVIDIA GeForce RTX 4090", "cpu", "")


@pytest.mark.parametrize("name", sorted(H100))
def test_each_h100_has_its_own_row(name):
    bf16, hbm = H100[name]
    assert chips.peak_bf16_tflops(name) == bf16
    assert chips.peak_hbm_gbps(name) == hbm
    assert chips.peak_bf16_tflops(name.lower()) == bf16  # case-blind
    dev = types.SimpleNamespace(device_kind=name)
    assert chips.peak_hbm_gbps(dev) == hbm


@pytest.mark.parametrize("kind", TPU_KINDS)
def test_tpu_kinds_give_the_references_numbers(kind):
    from ps_tpu.utils import chips as ref

    dev = types.SimpleNamespace(device_kind=kind)
    for port_fn, ref_fn in ((chips.peak_bf16_tflops, ref.peak_bf16_tflops),
                            (chips.peak_hbm_gbps, ref.peak_hbm_gbps)):
        want = ref_fn(dev)
        assert want is not None
        assert port_fn(kind) == port_fn(dev) == want


def test_tables_keep_every_reference_row():
    from ps_tpu.utils import chips as ref

    for port_table, ref_table in ((chips.PEAK_BF16_TFLOPS,
                                   ref.PEAK_BF16_TFLOPS),
                                  (chips.PEAK_HBM_GBPS, ref.PEAK_HBM_GBPS)):
        assert {k: port_table[k] for k in ref_table} == ref_table
        keys = list(port_table)
        for narrow in ("h100 pcie", "h100 nvl"):
            assert keys.index(narrow) < keys.index("h100")


@pytest.mark.parametrize("name", UNKNOWN)
def test_unknown_card_gives_none(name):
    assert chips.peak_bf16_tflops(name) is None
    assert chips.peak_hbm_gbps(name) is None


def test_smoke_script_reads_its_peaks_from_the_table():
    import chip_smoke

    # bitwise the constants the script used before the table
    assert chip_smoke._card_peaks("NVIDIA H100 80GB HBM3") == (3.35e12,
                                                               989e12)
    assert chip_smoke._card_peaks("NVIDIA H100 PCIe") == (2.0e12, 756e12)
    with pytest.raises(RuntimeError, match="NVIDIA A100-SXM4-80GB"):
        chip_smoke._card_peaks("NVIDIA A100-SXM4-80GB")
