"""Central configuration, a copy of ``guitar_tablature_classification_tpu.config``.

The PyTorch port keeps its own copy so that it never imports the JAX
package; the two copies define the same dataclasses, defaults and
``RECIPES``, so a ``--recipe`` name means the same thing in both.  The
field comments describe each knob as the JAX package implements it, and
the timings quoted there were taken on a TPU.  How the port honours each
knob is documented where it is read (``models/tabnet.py``,
``ops/cqt.py``).

The reference repo has no config system: hyperparameters are hard-coded
literals and absolute Colab/Kaggle/Windows paths (reference
``bestengine.py:1039-1049``, ``ViT_engine.py:574-586``, ``cqt.py:69-70``,
``jam_to_tablature.py:439-442``).  Here every entry point consumes one
frozen dataclass tree so runs are reproducible and serializable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable


# MIDI pitches of the open strings, low E (E2=40) to high e (E4=64).
# Matches reference ``jam_to_tablature.py`` open_string_pitches and the
# GuitarSet per-string annotation order (data_source 0..5).
OPEN_STRING_MIDI: tuple[int, ...] = (40, 45, 50, 55, 59, 64)
NUM_STRINGS: int = 6
NUM_FRETS: int = 19  # frets 0..18; fret 0 doubles as "open / not sounding"


@dataclass(frozen=True)
class CQTConfig:
    """Constant-Q transform recipe.

    Defaults reproduce the training recipe of reference ``cqt.py:52-58``:
    sr 44100, hop 1024, 96 bins, 12 bins/octave, fmin C1, |CQT|**4,
    ``amplitude_to_db(ref=max)`` (top_db 80), then the -60 dB -> -120 dB
    noise gate of ``cqt.py:10-13``.  The alternative serving recipe of
    ``tablature_generator.py:619`` (sr 22050, hop 512, 84 bins, fmin C2)
    is :func:`CQTConfig.serving_cnn`.
    """

    sample_rate: int = 44100
    hop_length: int = 1024
    n_bins: int = 96
    bins_per_octave: int = 12
    fmin: float = 32.70319566257483  # C1
    filter_scale: float = 1.0
    window: str = "hann"
    magnitude_power: float = 4.0  # |CQT|**4 before dB (cqt.py:56)
    # librosa.cqt(scale=True) bin gains: each bin scaled so its response
    # to a sinusoid is ~sqrt(filter_length)/2 — a ~24 dB amplitude tilt
    # across 8 octaves that survives the ref=max dB + gate. False = flat
    # L1 gains (the round-1 spec; kept for comparison).
    scale: bool = True
    # librosa 0.10 cqt default pad_mode='constant' (zeros); 'reflect'
    # matches older librosa and the round-1 spec.
    pad_mode: str = "constant"
    top_db: float = 80.0  # librosa amplitude_to_db default
    gate_threshold_db: float = -60.0  # cqt_lim threshold (cqt.py:10-13)
    gate_floor_db: float = -120.0
    amin: float = 1e-5  # librosa amplitude_to_db amin
    # Frame-GEMM MXU precision.  "highest" = true-fp32 passes, exact
    # vs the NumPy golden (default).  "bf16x3" = manual 3-pass hi/lo
    # bf16 split (~fp32 to 16 mantissa bits; Mosaic rejects the HIGH
    # enum so the middle point is hand-rolled — ops/cqt_pallas.py).
    # "default" = single bf16 pass: measured 1.74x faster CQT at
    # B=1024 with 9/884736 (0.001%) gate flips and <=0.31 dB error on
    # ungated bins over guitar-like signals
    # (tools/probe_cqt_precision.py) — a throughput knob for
    # native-recipe training where the CQT is ~half the step.
    precision: str = "highest"  # highest | bf16x3 | default
    # Zero-support split for the Pallas frame-GEMM (ops/cqt_pallas.py
    # cqt_fused_split): the upper half of the bins' short centered
    # kernels get their own single-tile GEMM and k-tiles that only touch
    # structural zero padding are skipped — ~2.2x less GEMM work for the
    # 0.2 s recipe, dropping exactly-zero terms only.  "auto" enables it
    # whenever the geometry allows (pad_mode='constant', <=64 bins per
    # half); "off" forces the dense kernel (the parity baseline).
    gemm_split: str = "auto"  # auto | on | off
    # Pallas kernel rows-per-grid-block.  None = auto: pick the largest
    # block whose VMEM-resident audio slab stays within budget — large
    # blocks amortize the filterbank stream (25 MB re-read per block),
    # which is the exposed bottleneck once the GEMM drops below fp32
    # (see tools/probe_cqt_block.py).
    batch_block: int | None = None
    # Analysis windowing of raw audio into model inputs.
    window_seconds: float = 0.2
    hop_seconds: float = 0.1

    @property
    def window_samples(self) -> int:
        return int(self.window_seconds * self.sample_rate)

    @property
    def hop_samples(self) -> int:
        return int(self.hop_seconds * self.sample_rate)

    @property
    def q_factor(self) -> float:
        """librosa 0.10 Q: filter_scale / alpha with the symmetric
        relative bandwidth alpha = (2^(2/bpo) - 1) / (2^(2/bpo) + 1)
        (filters._relative_bandwidth; equal-tempered bins make it uniform
        across bins including the edges)."""
        r = 2.0 ** (2.0 / self.bins_per_octave)
        return self.filter_scale * (r + 1.0) / (r - 1.0)

    @property
    def n_frames(self) -> int:
        """CQT frames per analysis window (centered frames, librosa-style)."""
        return 1 + self.window_samples // self.hop_length

    @staticmethod
    def serving_cnn() -> "CQTConfig":
        """The divergent CNN-inference recipe (tablature_generator.py:619)."""
        return CQTConfig(
            sample_rate=22050,
            hop_length=512,
            n_bins=84,
            fmin=65.40639132514966,  # C2
            window_seconds=3.0,
            hop_seconds=1.5,
        )


@dataclass(frozen=True)
class DataConfig:
    """Dataset location, pairing and split semantics."""

    features_dir: str = "cqt_features"
    labels_dir: str = "tablatures"
    audio_dir: str = "audio"
    annotation_dir: str = "annotation"
    batch_size: int = 64
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    split_seed: int = 42  # seeded split semantics of ViT_dataloader.py:68-71
    image_size: int = 224
    # dB -> [0,1] normalization of ViT_dataloader.py:31-32.
    db_offset: float = 120.0
    db_scale: float = 120.0
    shuffle_seed: int = 0
    pack_records: bool = True  # pack small .npy files into record shards


@dataclass(frozen=True)
class ModelConfig:
    """Architecture selection and dimensions."""

    # resnet18 | resnet18_native | vit_s8 | vit_native | small_cnn | deepseek_v2
    arch: str = "resnet18"
    input_channels: int = 3
    num_strings: int = NUM_STRINGS
    num_frets: int = NUM_FRETS
    trunk_dim: int = 256
    dtype: str = "bfloat16"  # compute dtype for the backbone
    param_dtype: str = "float32"
    # ViT-S/8 dimensions (facebook/dino-vits8; ViT_model.py:11-15)
    vit_hidden: int = 384
    vit_layers: int = 12
    vit_heads: int = 6
    vit_patch: int = 8
    # Patch width for the vit_native arch's rectangular patches over the
    # raw [96, 9] CQT: (vit_patch, vit_native_patch_w) = (8, 3) -> a
    # 12x3 token grid (36 + CLS) vs the 224^2 recipe's 784 tokens.
    # Must divide n_frames (9 -> 1, 3 or 9).
    vit_native_patch_w: int = 3
    # Replace the patchify embedding with a stride-factored 3x3
    # conv/BN/GELU stack + 1x1 projection (Xiao et al. 2021, "Early
    # Convolutions Help Transformers See Better") — same token grid,
    # overlapping receptive fields.  ViT archs only; conv-stem
    # checkpoints are NOT HF/DINO-importable (different embed tree).
    vit_conv_stem: bool = False
    vit_mlp_ratio: float = 4.0
    dropout: float = 0.3
    remat: bool = False  # jax.checkpoint per block (activation memory vs FLOPs)
    # auto -> pallas on TPU (fused VMEM-resident-KV kernel, fwd + bwd),
    # xla elsewhere.  XLA's dot_product_attention materializes the
    # [B, H, N, N] weights in HBM — measured 166 of 228 ms of the ViT
    # train step at B=64 (DESIGN.md round-2 profiling).
    attention_impl: str = "auto"  # auto | xla | pallas
    # Fused ResNet stem (ops/stem_fusion.py + ops/stem_pallas.py):
    #   "on"    — precomposed GEMM front only: resize(224)∘tile∘
    #             normalize∘conv1 as GEMMs straight off the [96, 9] CQT
    #             (exact at fp32, same parameter tree).  Measured SLOWER
    #             end-to-end (39.6 vs 31.6 ms/step at B=256): the
    #             GEMM-produced conv1 output forces XLA layout
    #             conversions on the 112² tensors.
    #   "fused" — GEMM front in quadrant layout + Pallas BN/ReLU/maxpool
    #             forward+backward kernels: each 112² tensor crosses HBM
    #             exactly once per direction as bf16, and no XLA op ever
    #             sees it (which removes the layout-conversion failure
    #             mode of "on").  See DESIGN.md round-2 study.
    # For arch="resnet18_native", "fused" selects the native-geometry
    # fused stem instead (ops/stem_native.py): conv1 as two row-parity
    # stride-(4,2) convs + one-pass Pallas stats and BN/ReLU/maxpool
    # kernels over the [48, 5, 64] conv1 output ("on" has no native
    # meaning and is ignored there).  NOTE: on the native geometry this
    # is a measured LOSS (30.3-30.9 vs 24.36 ms full model at B=8192 —
    # the tail kernels are launch-bound at 24-row blocks and Mosaic
    # OOMs every larger block; DESIGN.md round 4b).  "fused" is the
    # right default only for the 224² archs; native archs should keep
    # "off".
    stem_fusion: str = "off"  # on | off | fused
    # Fused trunk BatchNorms (ops/bn_pallas.py): every ResNet BN's
    # training-mode stat reductions (fwd mean/var, bwd sum(g)/sum(g·y))
    # run as single Pallas passes with the train-mode batch-stat
    # gradient emitted analytically.  Same variable tree as
    # nn.BatchNorm; eval mode is a plain XLA affine.  Measured 64 %
    # SLOWER end-to-end at B=256 (47.8 vs 29.1 ms/step): XLA already
    # schedules the stat reductions inside its fused conv pipeline and
    # the 40 Pallas call boundaries break that fusion (DESIGN.md).
    # Kept as a tested variant.
    bn_fusion: str = "off"  # on | off
    # Width-1 conv contraction (models/resnet.py Conv3x3): on the native
    # trunk's 6x1/3x1 tail stages a 3x3 conv's side kernel columns only
    # ever multiply zero padding; "slim" contracts the center column
    # only — output-equal, trajectory-equal, ~1/3 of the trunk conv
    # FLOPs dropped (exact zeros only).  "dense" (default) additionally
    # rewrites the 3x1 stride-1 convs (layer4's three 512-ch convs at
    # native geometry) as one banded-dense GEMM [B, 3C] @ [3C, 3F] whose
    # M dimension is the raw batch — the feature map never splits into
    # 3-row tiles that waste 62 % of the MXU sublanes; other width-1
    # convs fall back to "slim".  Measured 23.88 vs 24.18 ms/step
    # side by side at B=8192 (isolated layer4 stack 4.70 vs 5.19 ms),
    # exact outputs and gradients (probe_w1_gemm.py / DESIGN.md round
    # 4c).  "gemm" computes every width-1 contraction as a row-stacked
    # GEMM ([B*h_out, 3C] @ [3C, F]) — measured SLOWER (31.6 ms: the
    # stack/pad data movement costs more than the sublane fill saves)
    # and kept as the rejected A/B arm.  "full" forces the dense 3x3
    # contraction (the parity baseline).  No effect on 224^2 inputs.
    w1_conv: str = "dense"  # dense | slim | gemm | full
    # GELU flavor: the reference's HF ViT uses exact erf-GELU, whose
    # transcendental costs ~18 ms/step at B=64 on the VPU.  The tanh
    # approximation's max abs error (~3e-4) is below bf16 activation
    # resolution, so "auto" uses tanh for bf16 compute and exact for
    # fp32 (keeping fp32 HF-parity tests exact).
    gelu: str = "auto"  # auto | exact | tanh
    # arch "deepseek_v2": DeepSeek-V2's published config.json keys under
    # their own names (hidden_size, num_hidden_layers, kv_lora_rank,
    # n_routed_experts, rope_scaling, ...; models/deepseek_v2.py KEYS),
    # plus aux_loss_alpha.  The port's own field: the JAX package has no
    # such arch.  Patches of vit_patch over the 224^2 image.
    deepseek: dict | None = field(default=None, hash=False)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule. CNN recipe = bestengine.py:872-878; ViT recipe
    = ViT_engine.py:244-264."""

    name: str = "adam"  # adam | adamw
    learning_rate: float = 5e-4
    weight_decay: float = 1e-5
    grad_clip_norm: float = 1.0
    label_smoothing: float = 0.05
    epochs: int = 20
    early_stop_patience: int = 7
    # ReduceLROnPlateau (bestengine.py:875)
    schedule: str = "plateau"  # plateau | cosine_warm_restarts | constant
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    # CosineAnnealingWarmRestarts (ViT_engine.py:254)
    cosine_t0: int = 5
    cosine_t_mult: int = 2
    cosine_eta_min: float = 1e-6
    # ViT backbone lr multiplier (ViT_engine.py:244-251)
    backbone_lr_scale: float = 1.0
    seed: int = 42
    # Spectrogram augmentation (the suite of ViT_engine.py:28-93; dormant
    # in the reference — the call is commented out at :284).
    augment: bool = False
    augment_prob: float = 0.5


@dataclass(frozen=True)
class MeshConfig:
    """The mesh of ranks for data and string-head parallelism.

    The reference's only distribution is ``nn.DataParallel``
    (bestengine.py:1032-1034); here a ``data`` axis splits the batch over
    ``torch.distributed`` ranks, with a second (optional) ``model`` axis
    that splits the per-string heads (:func:`.parallel.make_mesh`).
    """

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: use all devices
    model_parallel: int = 1


@dataclass(frozen=True)
class TrainConfig:
    cqt: CQTConfig = field(default_factory=CQTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: str = "checkpoints"
    checkpoint_name: str = "best_guitar_tab_model"
    log_every_steps: int = 50
    profile: bool = False

    @staticmethod
    def cnn_default() -> "TrainConfig":
        """bestengine.py main() recipe (lr 5e-4, smoothing .05, 20 epochs)."""
        return TrainConfig()

    @staticmethod
    def vit_default() -> "TrainConfig":
        """ViT_engine.py main() recipe (AdamW, cosine warm restarts,
        smoothing .1, 30 epochs, patience 10, backbone lr/10)."""
        return TrainConfig(
            model=ModelConfig(arch="vit_s8"),
            optim=OptimConfig(
                name="adamw",
                label_smoothing=0.1,
                epochs=30,
                early_stop_patience=10,
                schedule="cosine_warm_restarts",
                backbone_lr_scale=0.1,
            ),
            checkpoint_name="best_vit_guitar_tab_model",
        )

    @staticmethod
    def native_best() -> "TrainConfig":
        """Measured-best CNN recipe (`--recipe native-best`): the
        resnet18_native arch on the raw 96x9 CQT (no information is added
        by the reference's 224^2 bicubic upsample — DESIGN.md), the
        "default"-precision chunk-contraction CQT kernel (0.001 % gate
        flips; the max-throughput tier) and the measured batch knee.
        ~29x the 224^2 flagship's training throughput at equal-or-better
        accuracy on the synthetic benchmark.  The reference equivalent is
        the hard-coded literals of bestengine.py:1039-1049."""
        return TrainConfig(
            cqt=CQTConfig(precision="default"),
            data=DataConfig(batch_size=2048),
            model=ModelConfig(arch="resnet18_native"),
        )

    @staticmethod
    def vit_small_data() -> "TrainConfig":
        """Measured-best ViT recipe (`--recipe vit-small-data`):
        vit_native with coarse (16, 3) rectangular patches on the raw
        CQT — the DESIGN.md patch sweep's winner on BOTH axes (paired
        seeds: +6.3/+4.4 accuracy points over the (8, 3) default AND
        1.8x faster; 33x the 224^2 ViT), re-confirmed at the 43k-window
        GuitarSet scale (round-5 sweep: patch 8 scores 96.00 vs patch
        16's 96.17).  `backbone_lr_scale=1.0` since round 5: the
        reference's backbone-lr/10 split (ViT_engine.py:244-251) is a
        FINETUNING recipe that assumes pretrained DINO weights; training
        from scratch it costs a measured 0.44 accuracy points at scale
        (96.14-96.17 vs 95.70 — DESIGN.md round-5 sweep).  cosine_t0=10
        from the same sweep (96.17 vs 96.14 at t0=5, two-seed-confirmed
        winner).  `vit_conv_stem=True` since round 5c: the stride-
        factored 3x3 conv/BN/GELU embedding (same token grid) is worth
        +0.72/+0.93 points over the patchify conv at the 43k-window
        scale (96.89/97.05 two-seed vs 96.12-96.17) — the best accuracy
        of ANY arch in the repo, 0.4-0.5 over small_cnn's 96.51
        (DESIGN.md round-5 conv-stem study).  The reference equivalent
        is ViT_engine.py:574-586's literals."""
        base = TrainConfig.vit_default()
        return dataclasses.replace(
            base,
            model=dataclasses.replace(
                base.model, arch="vit_native", vit_patch=16,
                vit_conv_stem=True,
            ),
            optim=dataclasses.replace(
                base.optim, backbone_lr_scale=1.0, cosine_t0=10
            ),
        )


# Named recipe registry for the CLI (`tab-train --recipe ...`): the
# measured-best configurations, so a user gets the DESIGN.md winners
# without reading DESIGN.md.
RECIPES: dict[str, Callable[[], "TrainConfig"]] = {
    "cnn-reference": TrainConfig.cnn_default,
    "vit-reference": TrainConfig.vit_default,
    "native-best": TrainConfig.native_best,
    "vit-small-data": TrainConfig.vit_small_data,
}


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def _from_dict(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in d.items():
        if key not in fields:
            raise KeyError(f"unknown config field {cls.__name__}.{key}")
        ftype = fields[key].type
        sub = {
            "cqt": CQTConfig, "data": DataConfig, "model": ModelConfig,
            "optim": OptimConfig, "mesh": MeshConfig,
        }
        if key in sub and isinstance(val, dict):
            kwargs[key] = _from_dict(sub[key], val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
        del ftype
    return cls(**kwargs)


def train_config_from_json(text: str) -> TrainConfig:
    return _from_dict(TrainConfig, json.loads(text))
