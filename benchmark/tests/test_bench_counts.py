"""The yardstick's arithmetic against counts worked out by hand, and the
configurations' nominal operations (which the MFU readers take) against a
count of each model's layers."""

from __future__ import annotations

import pytest

from benchmark import harness, peaks


def resnet18_macs(size: int = 224, in_channels: int = 3, features: int = 256) -> dict:
    """Multiply-adds of one image through ResNet-18 by layer."""
    out = {}
    s = size // 2
    out["conv1"] = s * s * 64 * 7 * 7 * in_channels
    s //= 2  # max-pool
    cin = 64
    for stage in range(4):
        cout = 64 * 2**stage
        if stage:
            s //= 2
        n = 0
        for block in range(2):
            c0 = cin if block == 0 else cout
            n += s * s * cout * 9 * c0 + s * s * cout * 9 * cout
            if block == 0 and (stage or cin != cout):
                n += s * s * cout * c0  # 1x1 downsample
        out[f"layer{stage + 1}"] = n
        cin = cout
    out["fc"] = cin * features
    return out


def resnet18_native_macs(h: int = 96, w: int = 9, in_channels: int = 1,
                         features: int = 256) -> dict:
    """Multiply-adds of one [h, w] input through ResNet-18 by layer, each
    3x3 kernel counted whole (as the plain convolution computes it)."""
    def out(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    h, w = out(h, 7, 2, 3), out(w, 7, 2, 3)
    res = {"conv1": h * w * 64 * 49 * in_channels}
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)  # max-pool
    cin = 64
    for stage in range(4):
        cout = 64 * 2**stage
        if stage:
            h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)
        n = h * w * cout * 9 * (cin + 3 * cout)
        if cin != cout:
            n += h * w * cout * cin  # 1x1 downsample
        res[f"layer{stage + 1}"] = n
        cin = cout
    res["fc"] = cin * features
    return res


def vit_macs(hidden: int, layers: int, heads: int, patch: int, size: int = 224,
             mlp: int | None = None, channels: int = 3) -> dict:
    """Multiply-adds of one image through the ViT backbone by part."""
    mlp = mlp or 4 * hidden
    patches = (size // patch) ** 2
    n = patches + 1
    dense = n * (3 * hidden * hidden + hidden * hidden + 2 * hidden * mlp)
    attention = 2 * n * n * hidden  # q k^T and p v over all heads
    return {"patch_embed": patches * hidden * patch * patch * channels,
            "blocks_dense": layers * dense, "blocks_attention": layers * attention}


def test_resnet18_forward_by_layer():
    # conv1 7x7/2 over 3 channels onto 112^2 x 64
    assert resnet18_macs()["conv1"] == 112 * 112 * 64 * 7 * 7 * 3
    # layer1: four 3x3 64->64 convs at 56^2
    assert resnet18_macs()["layer1"] == 4 * 56 * 56 * 64 * 9 * 64
    # layer2: 3x3 64->128 /2, three 3x3 128->128, the 1x1 64->128 /2, at 28^2
    layer2 = 28 * 28 * 128 * (9 * 64 + 3 * 9 * 128 + 64)
    by_layer = resnet18_macs()
    assert by_layer["layer2"] == layer2
    assert by_layer["layer3"] == 14 * 14 * 256 * (9 * 128 + 3 * 9 * 256 + 128) == layer2
    assert by_layer["layer4"] == 7 * 7 * 512 * (9 * 256 + 3 * 9 * 512 + 256) == layer2
    assert by_layer["fc"] == 512 * 256
    heads = 6 * (256 * 128 + 128 * 64 + 64 * 19)
    nominal = harness.load_cell("flagship_train").config["nominal"]
    assert nominal["by_layer"] == by_layer and nominal["heads"] == heads
    total = 118_013_952 + 462_422_016 + 3 * 411_041_792 + 131_072 + heads
    assert nominal["forward_macs"] == total  # 1.814 G multiply-adds
    assert nominal["train_flops"] == 6 * total


def test_resnet18_native_forward_by_layer():
    by_layer = resnet18_native_macs()
    # conv1 7x7/2 over one channel onto 48x5 x 64; max-pool to 24x3
    assert by_layer["conv1"] == 48 * 5 * 64 * 49 == 752_640
    assert by_layer["layer1"] == 4 * 24 * 3 * 64 * 9 * 64 == 10_616_832
    # 12x2, 6x1 and 3x1 maps after the strided stages
    assert by_layer["layer2"] == 12 * 2 * 128 * (9 * 64 + 3 * 9 * 128 + 64) == 12_582_912
    assert by_layer["layer3"] == 6 * 1 * 256 * (9 * 128 + 3 * 9 * 256 + 128) == 12_582_912
    assert by_layer["layer4"] == 3 * 1 * 512 * (9 * 256 + 3 * 9 * 512 + 256) == 25_165_824
    assert by_layer["fc"] == 512 * 256
    heads = 6 * (256 * 128 + 128 * 64 + 64 * 19)
    nominal = harness.load_cell("native_train").config["nominal"]
    assert nominal["by_layer"] == by_layer and nominal["heads"] == heads
    assert nominal["forward_macs"] == sum(by_layer.values()) + heads == 62_085_248
    assert nominal["train_flops"] == 6 * nominal["forward_macs"]  # 0.373 GFLOP a segment


def test_vit_s8_forward_by_part():
    n = 785  # 28^2 patches + CLS
    parts = vit_macs(384, 12, 6, 8)
    assert parts["patch_embed"] == 784 * 384 * 8 * 8 * 3
    # per block: the q, k, v and output projections, the 1536-wide MLP
    assert parts["blocks_dense"] == 12 * n * (4 * 384 * 384 + 2 * 384 * 1536)
    # per block and head: q k^T and p v, 785 x 785 x 64 each
    assert parts["blocks_attention"] == 12 * 6 * 2 * n * n * 64
    heads = 384 * 512 + 512 * 256 + 6 * 256 * 19
    nominal = harness.load_cell("vit_train").config["nominal"]
    assert nominal["forward_macs"] == sum(parts.values()) + heads  # 22.41 G
    assert nominal["train_flops"] == 6 * nominal["forward_macs"]
    assert abs(nominal["train_flops"] / 134.43e9 - 1) < 1e-3


@pytest.mark.parametrize("batch", [256, 128, 1])
def test_stem_tail_bounds(batch):
    n_y = batch * 112 * 112 * 64  # conv1's output, bf16
    n_pool = batch * 56 * 56 * 64
    by_bytes = {"stem_stats": 2 * n_y + 8 * 64, "stem_fwd": 2 * (n_y + n_pool) + 8 * 64,
                "stem_bwd": 2 * (2 * n_y + n_pool) + 16 * 64}
    for kernel, nbytes in by_bytes.items():
        assert peaks.stem_bound_s(kernel, batch) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    if batch == 256:  # the smoke's bound of stem_stats at the flagship's batch
        assert peaks.stem_bound_s("stem_stats", 256) * 1e3 == pytest.approx(0.1227, abs=1e-4)


@pytest.mark.parametrize("batch", [64, 128, 8])
def test_attention_bounds(batch):
    n, h, d = 785, 6, 64
    elems = batch * n * h * d
    fwd_ops, bwd_ops = 4 * batch * h * n * n * d, 10 * batch * h * n * n * d
    fwd_bytes = 4 * 2 * elems + 4 * batch * h * n
    bwd_bytes = 8 * 2 * elems + 4 * batch * h * n
    assert peaks.attention_bound_s("attn_fwd", batch, n, h) == pytest.approx(
        max(fwd_ops / 989e12, fwd_bytes / 3.35e12), rel=1e-12)
    assert peaks.attention_bound_s("attn_bwd", batch, n, h) == pytest.approx(
        max(bwd_ops / 989e12, bwd_bytes / 3.35e12), rel=1e-12)
    if batch == 64:  # the smoke's bounds at vit_s8's training shape
        assert peaks.attention_bound_s("attn_fwd", 64, n, h) * 1e3 == pytest.approx(0.06125, abs=2e-5)
        assert peaks.attention_bound_s("attn_bwd", 64, n, h) * 1e3 == pytest.approx(0.1531, abs=1e-4)


def test_configuration_files_state_their_counts():
    """Each configuration's ``nominal`` from its own sizes, by the counts
    above: the MFU readers take these numbers and nothing else."""
    for cell in ("flagship_train", "vit_train", "native_train"):
        cfg = harness.load_cell(cell).config
        m = cfg["model"]
        if m["arch"] == "resnet18_native":
            body = sum(resnet18_native_macs(cfg["cqt"]["n_bins"], 9, 1, m["trunk_dim"]).values())
            heads = m["num_strings"] * (m["trunk_dim"] * 128 + 128 * 64 + 64 * m["num_frets"])
        elif m["arch"] == "resnet18":
            body = sum(resnet18_macs(224, m["input_channels"], m["trunk_dim"]).values())
            heads = m["num_strings"] * (m["trunk_dim"] * 128 + 128 * 64 + 64 * m["num_frets"])
        else:
            body = sum(vit_macs(m["vit_hidden"], m["vit_layers"], m["vit_heads"],
                                m["vit_patch"]).values())
            heads = m["vit_hidden"] * 512 + 512 * 256 + m["num_strings"] * 256 * m["num_frets"]
        assert cfg["nominal"]["forward_macs"] == body + heads
        assert cfg["nominal"]["train_flops"] == 6 * (body + heads)


@pytest.mark.parametrize("batch", [2048, 128, 1])
def test_cqt_default_bounds(batch):
    """B1's default-tier bound against the port's own counts of the
    window's multiply-adds and filter values (``chip_smoke.py``'s)."""
    from guitar_tablature_classification_tpu_torch.config import CQTConfig
    from guitar_tablature_classification_tpu_torch.ops import cqt_cuda
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend

    cqt = harness.load_cell("native_train").config["cqt"]
    cfg = CQTConfig(**cqt)
    fb = CQTFrontend(cfg).filterbank
    macs = cqt_cuda.needed_macs(fb, cfg, 8820)
    values = cqt_cuda.needed_filter_values(fb, cfg, 8820)
    assert peaks.cqt_counts(cqt) == (macs, values)
    nbytes = 4 * batch * 8820 + 2 * values + 4 * batch * 96 * 9  # audio, bf16 filter, dB out
    want = max(nbytes / 3.35e12, 2 * macs * batch / 989e12)
    assert peaks.cqt_bound_s(batch, cqt) == pytest.approx(want, rel=1e-12)
    assert nbytes / 3.35e12 > 2 * macs * batch / 989e12  # byte-bound at every batch
    if batch == 2048:  # the kernel table's bound of the default tier
        assert peaks.cqt_bound_s(2048, cqt) * 1e3 == pytest.approx(0.02415, abs=1e-5)
    with pytest.raises(ValueError):
        peaks.cqt_bound_s(batch, dict(cqt, precision="highest"))


def test_cqt_share_reads_the_default_tiers_kernels():
    """``cqt_roofline.*``: the bound of each traced call over the device
    time of B1's two kernels; None where B1 did not run on the tensor
    cores, and an error where the trace lost a record."""
    from benchmark import devtrace, readers
    from benchmark.harness import Run

    cell = harness.load_cell("native_serve")
    mma = "void (anonymous namespace)::cqt_mma_kernel<true, 1>(float const*, int)"
    launched = [(mma, 0.0, 30.0), ("cqt_db_kernel", 30.0, 35.0), ("other_kernel", 35.0, 90.0),
                (mma, 100.0, 104.0), ("cqt_db_kernel", 104.0, 105.0)]
    counts = {"cqt_fused": 2, "cqt_fused_mma": 2}
    trace = devtrace.Trace(stretch=(0.0, 200.0), device=[], launched=launched, host=[],
                           extra={"counts": counts, "forward_batches": [128, 8],
                                  "backward": False})
    run = Run(cell=cell, trace=trace)
    want = peaks.cqt_bound_s(128, cell.config["cqt"]) + peaks.cqt_bound_s(8, cell.config["cqt"])
    assert readers.cqt_share(run, backward=False) == pytest.approx(100 * want / 40e-6)
    assert readers.cqt_share(run, backward=True) is None
    trace.extra["counts"] = {"cqt_fused": 2, "cqt_fused_mma": 0}
    assert readers.cqt_share(run, backward=False) is None
    trace.extra["counts"] = {"cqt_fused": 3, "cqt_fused_mma": 3}
    with pytest.raises(RuntimeError):
        readers.cqt_share(run, backward=False)


def test_device_time_a_segment_reads_the_union_of_the_device_work():
    """``train_device_us_per_segment`` and ``train_mfu.device``: the union
    of the traced steps' kernel, copy and set intervals (overlaps counted
    once, the part outside the stretch left out) over their segments; None
    without a traced training stretch."""
    from benchmark import devtrace, peaks, readers
    from benchmark.harness import Run

    cell = harness.load_cell("native_train")
    device = [("kernel", "a", 10.0, 40.0), ("gpu_memcpy", "Memcpy HtoD", 30.0, 50.0),
              ("kernel", "b", 60.0, 70.0), ("gpu_memset", "Memset", 190.0, 260.0)]
    trace = devtrace.Trace(stretch=(0.0, 200.0), device=device, launched=[], host=[],
                           extra={"counts": {}, "forward_batches": [2048, 2048],
                                  "backward": True})
    run = Run(cell=cell, trace=trace)
    busy_s = (40.0 + 10.0 + 10.0) * 1e-6
    assert readers.device_us_per_segment(run) == pytest.approx(1e6 * busy_s / 4096)
    flops = cell.config["nominal"]["train_flops"] * 4096
    assert readers.device_mfu(run) == pytest.approx(100 * flops / busy_s / peaks.PEAK_FLOPS["bf16"])
    trace.extra["backward"] = False
    assert readers.device_us_per_segment(run) is None and readers.device_mfu(run) is None
    assert readers.device_us_per_segment(Run(cell=cell)) is None
