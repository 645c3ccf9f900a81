"""Run configuration of the PyTorch port.

The port's own ``Schema``, ``Config`` and metadata round trip.  Field
names, defaults and the *metadata schema* (the JSON field names written
into the HDF5 ``meta`` attribute and into checkpoints) are those of the
JAX package's ``pylc_tpu/config.py`` and, through it, of the reference's
``Parameters`` (reference: config.py:36-82, db/database.py:235), so a DB
or a checkpoint written by any of the three rehydrates in the others.
``tests/test_torch_config.py`` holds this module equal to the JAX
package's field by field.  Only the ``schema`` path differs between the
packages: each resolves schema names against its own ``schemas/``.

A few fields configure things only the JAX package has (``rng_impl``,
``mesh_shape``); they stay so that a config passes between the packages
unchanged, and their comments say that the port ignores them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

SCHEMA_DIR = os.path.join(os.path.dirname(__file__), "schemas")
DEFAULT_SCHEMA = os.path.join(SCHEMA_DIR, "schema_a.json")


@dataclass(frozen=True)
class Schema:
    """Land-cover class taxonomy loaded from a schema JSON file.

    Mirrors reference config.py:279-314 (``Parameters.get_schema``).
    """

    path: str
    class_labels: Tuple[str, ...]
    class_codes: Tuple[str, ...]
    palette_hex: Tuple[str, ...]
    palette_rgb: Tuple[Tuple[int, int, int], ...]

    @property
    def n_classes(self) -> int:
        return len(self.class_labels)

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.path))[0]

    @staticmethod
    def load(schema_path: str) -> "Schema":
        if not os.path.isfile(schema_path):
            # allow bare names like 'schema_a' to resolve to packaged schemas
            candidate = os.path.join(
                SCHEMA_DIR, os.path.basename(schema_path)
            )
            if not candidate.endswith(".json"):
                candidate += ".json"
            if os.path.isfile(candidate):
                schema_path = candidate
            else:
                raise FileNotFoundError(
                    f"Schema file not found: {schema_path}"
                )
        with open(schema_path) as f:
            d = json.load(f)
        classes = d["classes"]
        return Schema(
            path=schema_path,
            class_labels=tuple(c["label"] for c in classes),
            class_codes=tuple(c["code"] for c in classes),
            palette_hex=tuple(c["colour"]["hex"] for c in classes),
            palette_rgb=tuple(tuple(c["colour"]["rgb"]) for c in classes),
        )


# Fields that ride in the HDF5 `meta` attribute / checkpoint meta blob.
# Names match the reference Parameters vars (config.py:85-248) so that a
# meta JSON written by either implementation rehydrates in the other.
META_FIELDS = (
    "id", "ch", "schema", "schema_name", "n_classes", "class_labels",
    "class_codes", "palette_hex", "palette_rgb", "tile_size", "stride",
    "scale", "scales", "n_samples", "tile_px_count", "px_mean", "px_std",
    "px_dist", "dset_px_dist", "dset_px_count", "probs", "weights",
    "m2", "jsd", "extract", "n_tiles", "arch", "backbone", "normalize_default",
)

# The subset of META_FIELDS that are facts about the *data* (palette,
# geometry, statistics).  When a tile DB's metadata rehydrates a config
# at train time, only these may override user settings — network
# hyperparameters (arch, backbone, ...) stay with the CLI/config.  (The
# reference's global-singleton update stomps user args with DB metadata,
# db/database.py:164; see docs/DEVIATIONS.md.)
DATA_META_FIELDS = (
    "id", "ch", "schema", "schema_name", "n_classes", "class_labels",
    "class_codes", "palette_hex", "palette_rgb", "tile_size", "stride",
    "scale", "scales", "n_samples", "tile_px_count", "px_mean", "px_std",
    "px_dist", "dset_px_dist", "dset_px_count", "probs", "weights",
    "m2", "jsd", "extract", "n_tiles",
)


@dataclass
class Config:
    """All defaults of the reference ``Parameters`` (config.py:85-248),
    carried explicitly instead of via a module-global singleton.
    """

    # general
    id: Optional[str] = None
    ch: int = 3
    n_workers: int = 0

    # schema
    schema: str = DEFAULT_SCHEMA
    schema_name: str = "schema_a"
    class_labels: List[str] = field(default_factory=list)
    class_codes: List[str] = field(default_factory=list)
    palette_hex: List[str] = field(default_factory=list)
    palette_rgb: List[List[int]] = field(default_factory=list)
    n_classes: int = 9

    # default paths (reference config.py:124-132)
    root: str = "./data/"
    img_dir: str = "./data/raw/images/"
    mask_dir: str = "./data/raw/masks/"
    db_dir: str = "./data/db/"
    output_dir: str = "./data/outputs/"
    save_dir: str = "./data/save/"
    model_dir: str = "./data/models/"

    # extraction (reference config.py:134-143)
    n_samples: int = 0
    tile_size: int = 512
    stride: int = 512
    scale: float = 1.0
    scales: List[float] = field(default_factory=lambda: [1.0])
    tiling_factor: int = 700
    n_tiles: int = 0
    extract: Optional[Dict[str, Any]] = None

    # augmentation (reference config.py:145-151)
    aug_n_samples_ratio: float = 0.36
    aug_oversample_rate_range: Tuple[int, int] = (0, 4)
    aug_rate_coef_range: Tuple[int, int] = (1, 21)
    aug_threshold_range: Tuple[float, float] = (0.0, 3.0)
    alpha: float = 0.19

    # database (reference config.py:156-160)
    buffer_size: int = 1000
    partition: float = 0.2
    clip: float = 1.0

    # normalization defaults (reference config.py:167-174)
    normalize_default: bool = False
    px_rgb_mean: List[float] = field(
        default_factory=lambda: [132.47, 144.47, 149.45])
    px_rgb_std: List[float] = field(
        default_factory=lambda: [24.85, 22.04, 18.77])
    px_grayscale_mean: float = 142.01
    px_grayscale_std: float = 23.66

    # profile metadata (reference config.py:176-185)
    px_mean: Optional[List[float]] = None
    px_std: Optional[List[float]] = None
    px_dist: Optional[List[List[int]]] = None
    dset_px_dist: Optional[List[int]] = None
    dset_px_count: int = 0
    probs: Optional[List[float]] = None
    weights: Optional[List[float]] = None
    m2: float = 0.0
    jsd: float = 1.0

    # network (reference config.py:187-222)
    pretrained: Any = "./data/models/resnet101-5d3b4d8f.pth"
    n_epochs: int = 20
    batch_size: int = 8
    dropout: float = 0.5
    crop_target: bool = False
    lr: float = 1e-4
    lr_min: float = 1e-6
    lr_max: float = 0.1
    gamma: float = 0.9
    momentum: float = 0.9
    weighted: bool = False
    dice_weight: float = 0.5
    ce_weight: float = 0.5
    focal_weight: float = 0.5
    dice_smooth: float = 1.0
    weight_decay: float = 5e-5
    fl_gamma: float = 2.0
    fl_alpha: float = 0.25
    fl_reduction: str = "mean"
    grad_clip: float = 0.5
    # LR multiplier for the non-backbone ('head': ASPP+decoder) params.
    # The reference defines get_1x_lr_params/get_10x_lr_params for this
    # split (models/architectures/deeplab.py:57-79) but never wires
    # them into its optimizer; here 10.0 enacts that intent (1.0 = off).
    head_lr_mult: float = 1.0
    optim_type: str = "adam"
    sched_type: str = "step_lr"
    arch: str = "deeplab"
    backbone: str = "resnet"
    norm_type: str = "batch"
    activ_type: str = "relu"
    up_mode: str = "upsample"

    # U-Net valid-conv geometry (reference config.py:224-236)
    input_size: int = 512
    output_size: int = 324
    unet_depth: int = 5
    unet_wf: int = 6  # first-layer filters = 2**wf

    # training loop / reporting
    resume_checkpoint: bool = False
    # Train-split shuffling (the reference's DataLoader hardcodes
    # shuffle=True, train.py:40).  Off gives a fully deterministic,
    # process-count-invariant global batch ORDER: contiguous per-process
    # shards concatenate to exactly the single-process stream, which is
    # what makes the 1-proc vs N-proc equivalence test exact in the
    # presence of dropout (dropout masks bind to batch SLOTS, so BN
    # moments after dropout are not row-order invariant — see
    # tests/test_multiprocess_train.py).
    shuffle: bool = True
    report: int = 20
    save_logits: bool = False
    aggregate_metrics: bool = False

    # compute dtype (bf16 runs under autocast) and kernel policy
    compute_dtype: str = "bfloat16"
    mesh_shape: Optional[Dict[str, int]] = None  # JAX package only; ignored
    fused_loss: str = "auto"  # auto|on|off: the fused loss on K2a/K2b

    # dense-CRF mean-field refinement (net-new capability: the reference
    # README advertises a CRF filter but ships no code — SURVEY.md
    # headline facts; ops/crf.py).  Defaults picked from the measured
    # accuracy-vs-throughput frontier in docs/CRF_TUNING.md.
    crf: bool = False
    crf_iters: int = 5
    crf_radius: int = 3
    crf_downsample: int = 2     # message-passing grid subsampling
    crf_w_app: float = 3.0      # appearance (bilateral) kernel weight
    crf_sigma_app: float = 3.0  # appearance spatial sigma (grid px)
    crf_sigma_color: float = 13.0
    crf_w_smooth: float = 1.0   # smoothness (Gaussian) kernel weight
    crf_sigma_smooth: float = 1.5

    # the JAX package's per-step RNG implementation; the port draws from
    # torch.Generator and ignores it
    rng_impl: str = "rbg"

    # rematerialize a DeepLab's backbone blocks in training
    # (torch.utils.checkpoint per block, models/deeplab.py); no CLI flag
    remat_backbone: bool = False

    # choice lists (reference config.py:211-222; 'syncbatch' typo fixed)
    ch_options: Tuple[int, ...] = (1, 3)
    optim_options: Tuple[str, ...] = ("adam", "sgd")
    sched_options: Tuple[str, ...] = ("step_lr", "cyclic_lr", "anneal")
    arch_options: Tuple[str, ...] = ("deeplab", "unet", "resunet")
    backbone_options: Tuple[str, ...] = ("resnet", "xception",
                                         "mobilenet", "drn")
    norm_options: Tuple[str, ...] = ("batch", "instance", "layer", "syncbatch")
    activ_options: Tuple[str, ...] = ("relu", "lrelu", "selu", "gelu")
    up_mode_options: Tuple[str, ...] = ("upconv", "upsample")

    # ------------------------------------------------------------------ #

    def __post_init__(self):
        if not self.class_labels:
            self.apply_schema(Schema.load(self.schema))

    @property
    def ch_label(self) -> str:
        return "grayscale" if self.ch == 1 else "colour"

    @property
    def tiles_per_image(self) -> int:
        # reference config.py:142
        return int(sum(self.tiling_factor * s for s in self.scales))

    @property
    def tile_px_count(self) -> int:
        return self.tile_size * self.tile_size

    @property
    def pad_size(self) -> int:
        return (self.input_size - self.output_size) // 2

    @property
    def crop_window(self) -> Tuple[int, int]:
        """U-Net target-mask crop [94:418] (reference config.py:230-236)."""
        return (self.pad_size, self.pad_size + self.output_size)

    def apply_schema(self, schema: Schema) -> "Config":
        self.schema = schema.path
        self.schema_name = schema.name
        self.class_labels = list(schema.class_labels)
        self.class_codes = list(schema.class_codes)
        self.palette_hex = list(schema.palette_hex)
        self.palette_rgb = [list(c) for c in schema.palette_rgb]
        self.n_classes = schema.n_classes
        return self

    def replace(self, **kwargs) -> "Config":
        """Pure update: returns a new Config with the given fields set
        (replaces reference Parameters.update, config.py:250-277)."""
        new = dataclasses.replace(self)
        for k, v in kwargs.items():
            if v is None:
                continue
            if isinstance(getattr(type(new), k, None), property):
                continue  # derived fields (tile_px_count, pad_size, ...)
            if hasattr(new, k):
                setattr(new, k, v)
        if "schema" in kwargs and kwargs["schema"]:
            new.apply_schema(Schema.load(kwargs["schema"]))
        return new

    # ---------------- metadata (JSON) round-trip ----------------------- #

    def to_meta(self) -> Dict[str, Any]:
        """Serialize metadata fields to a plain dict (for the HDF5 `meta`
        attribute / checkpoint blob; reference db/database.py:235)."""
        out = {}
        for k in META_FIELDS:
            v = getattr(self, k, None)
            out[k] = v
        # extra fields the reference also dumps and that matter for parity
        out["normalize_default"] = self.normalize_default
        out["buffer_size"] = self.buffer_size
        out["clip"] = self.clip
        return out

    def to_meta_json(self) -> str:
        return json.dumps(self.to_meta())

    @staticmethod
    def from_meta(meta: Dict[str, Any], base: Optional["Config"] = None,
                  fields: Optional[Tuple[str, ...]] = None) -> "Config":
        """Rehydrate a Config from a meta dict written by this package or
        by the reference (which dumps *all* Parameters vars —
        db/database.py:235). Unknown keys are ignored.  ``fields``
        restricts which keys may be applied (e.g. DATA_META_FIELDS so DB
        metadata can't stomp user-chosen network settings)."""
        cfg = dataclasses.replace(base) if base is not None else Config()
        for k, v in meta.items():
            if fields is not None and k not in fields:
                continue
            if k.endswith("_options") or v is None:
                continue
            if isinstance(getattr(type(cfg), k, None), property):
                continue  # derived fields
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    @staticmethod
    def from_meta_json(s: str, base: Optional["Config"] = None,
                       fields: Optional[Tuple[str, ...]] = None) -> "Config":
        return Config.from_meta(json.loads(s), base, fields)

    # ---------------- identifiers -------------------------------------- #

    def gen_model_id(self) -> str:
        """Model id format preserved from reference models/model.py:488-490:
        pylc_<arch>_ch<channels>_<schema_name>."""
        return f"pylc_{self.arch}_ch{self.ch}_{self.schema_name}"

    def gen_db_id(self) -> str:
        """Extraction DB id (reference utils/extract.py:56)."""
        return f"_db_pylc_{self.ch_label}_{int(time.time())}"

    def describe(self) -> str:
        lines = ["\nConfiguration\n------"]
        for f in dataclasses.fields(self):
            if f.name.endswith("_options"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, list) and len(v) > 8:
                v = f"[{len(v)} items]"
            lines.append(f"{f.name:24s}{v}")
        return "\n".join(lines)
