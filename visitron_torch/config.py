"""The run configuration of ``python -m visitron_torch.run``
(visitron_tpu/config.py: ``RunConfig``).

One dataclass holds every flag of the reference's run scripts; the fields,
their defaults, the checks of ``__post_init__`` and the (de)serialisation
are the JAX package's, so every ``run_configs/**/*.json`` parses to the
same values in both packages.  ``rng_impl`` selects JAX's PRNG
implementation and has no effect in torch: it is kept so the files stay
compatible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class RunConfig:
    # paths / data
    data_root: str = "srv/task_data"
    connectivity_dir: str = "connectivity"
    img_feat_dir: str = "srv/img_features"
    img_feature_file: str = ""
    region_feature_prefix: str = ""
    model_name_or_path: str = ""       # pretrained Oscar weights (torch/HF dir)
    output_dir: str = "output"
    vocab_file: str = ""
    # offline feature pipeline inputs (extract_scene / extract_regions)
    matterport_dir: str = ""           # Matterport root with skybox JPEGs
    resnet_checkpoint: str = ""        # torchvision ResNet-152 .pth
    detector_weights: str = ""         # VG Faster R-CNN weight dump (.npz)
    objects_vocab: str = ""            # 1601-line class vocab (VG)
    attributes_vocab: str = ""         # 401-line attribute vocab (VG)

    # model dims (params.py:132-179)
    max_seq_length: int = 512
    max_img_seq_length: int = 256
    angle_feat_size: int = 4
    views: int = 36
    action_space: int = 36
    img_feature_dim: int = 2054
    lstm_img_feature_dim: int = 2048
    encoder_hidden_size: int = 512
    rnn_dim: int = 512
    aemb: int = 64
    wemb: int = 256
    bidir: bool = False
    detector_classes: int = 1601

    # task flags
    path_type: str = "trusted_path"    # planner_path | player_path | trusted_path
    feedback_method: str = "sample"
    add_ndh_data: bool = True
    add_r2r_data: bool = False
    add_r4r_data: bool = False
    add_rxr_data: bool = False
    oscar_setting: bool = False
    tar_back: bool = False
    masked_token_prediction: bool = False
    no_action_grounding: bool = False
    no_pretrained_model: bool = False
    only_finetune_classifier: bool = False
    question_asking_class_weight: float = 5.0
    blind: bool = False
    submit: bool = False
    test_only: bool = False            # skip training; write test submission

    # optimization (params.py:251-307)
    per_gpu_train_batch_size: int = 8
    per_gpu_eval_batch_size: int = 8
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    scheduler: str = "linear"
    max_grad_norm: float = 1.0
    agent_max_grad_norm: float = 40.0
    num_iterations: int = 20000
    num_epochs: int = 10
    warmup_steps: int = 0
    drop_out: float = 0.1              # BERT dropout
    dropout: float = 0.5               # agent dropout
    mlm_probability: float = 0.15
    ignoreid: int = -100

    # extended decoding (utils.py:381-427): logit scale for the
    # temperature/penalty feedback strategies
    temperature: float = 1.0

    # bookkeeping
    logging_steps: int = 50
    saving_steps: int = 1000
    eval_iters: list[int] = field(default_factory=lambda: [-1])
    seed: int = 88
    debug: bool = False
    resume: bool = False               # restore latest checkpoint and continue
    profile_steps: int = 0             # capture a torch.profiler trace of N steps
    # Async checkpoint saves: the files are written from a background thread
    # so the train loop overlaps checkpoint I/O with the next steps; meta.json
    # (the completeness marker --resume enumerates by) is committed once the
    # write is durable.  Preemption + final saves are always synchronous.
    async_checkpoints: bool = False

    # hardware.  Across the ranks of a process group (torchrun): mesh_dp x
    # mesh_tp for every training task, mesh_dp x mesh_sp, mesh_dp x mesh_cp
    # or mesh_dp x mesh_pp (one host) for pretrain
    # (visitron_torch/parallel).  In one process mesh_dp is 0 or 1 and the
    # other axes 1.
    mesh_dp: int = 0                   # 0 => all devices
    mesh_tp: int = 1
    mesh_pp: int = 1                   # >1: pipeline-parallel pretraining
    pipeline_microbatches: int = 0     # 0 => auto (<= 4*pp, divides the
                                       # per-dp-shard batch)
    mesh_sp: int = 1                   # >1: sequence-parallel pretraining
    mesh_cp: int = 1                   # >1: ring-attention context-parallel
                                       # pretraining
    use_bfloat16: bool = True
    use_flash_attention: bool = False  # flash attention kernels (K5) where
                                       # the fused gate refuses (S > 768)
    use_fused_attention: bool = True   # fused attention kernels (K1, K4)
    use_fused_layernorm: bool = True   # fused add+LayerNorm kernels (K2)
    use_fused_mlm_ce: bool = True      # fused masked softmax-CE kernels (K3):
                                       # no (B, S, vocab) fp32 tensor
    remat: bool = False                # rematerialize BERT layers in bwd
                                       # (activation memory ~ O(layers) less;
                                       # enables batch scaling beyond HBM)
    # JAX's PRNG implementation; no effect in torch (kept so the run-config
    # files stay compatible; the value is still checked).
    rng_impl: str = "rbg"
    # Store Adam first/second moments in bfloat16 (arithmetic stays fp32);
    # see train/optim.py:scale_by_adam_lowp.
    bf16_adam_moments: bool = False
    # ZeRO-1 (the optimizer state sharded over dp) and FSDP (the parameters
    # too), visitron_torch/parallel/mesh.py:DataParallel.
    zero1: bool = False
    fsdp: bool = False
    # Conv compute dtype of the offline feature extractors ("default": bf16
    # for extract_scene, fp32 for extract_regions; "bfloat16" or "float32"
    # forces both).
    feature_extract_dtype: str = "default"
    # Length-grouped shuffle batching: window (in batches) within which
    # instances are ordered by dialog length so padded length per batch stays
    # near its own maximum (pack_padded work-skipping equivalent); 0/1 = off.
    length_sort_window: int = 8

    # Speaker and back-translation augmentation: the speaker and augment
    # tasks, and the viewpoint fine-tune's --aug_data.
    aug_data: str = ""                # speaker-generated R2R-format JSON to
                                      # append to viewpoint training data
    speaker_checkpoint: str = ""      # speaker output_dir for `augment`
    num_aug: int = 1000               # walks to caption in `augment`
    max_words: int = 64               # speaker decode length
    aug_temperature: float = 0.0      # 0 = greedy captions; >0 samples
    aug_targets: bool = False         # stamp aug records with NDH targets
    aug_keep_fraction: float = 0.0    # 0 = no gate; in (0, 1] over-generate
                                      # 1/frac and keep the best speaker-CE
    speaker_feat_dropout: float = 0.3  # feature dropout on visual dims
    speaker_movement_frame: bool = False  # action angle feats as turn deltas

    def __post_init__(self):
        valid = ("planner_path", "player_path", "trusted_path")
        if self.path_type not in valid:
            raise ValueError(f"--path_type must be one of {valid}, got {self.path_type!r}")
        # "rl" (A2C with critic baseline) is an extension beyond the
        # reference's sample|teacher surface; the rest mirror utils.py:381-427.
        if self.feedback_method not in ("teacher", "argmax", "sample", "topk",
                                        "nucleus", "temperature", "penalty", "rl"):
            raise ValueError(f"invalid --feedback_method {self.feedback_method!r}")
        if self.scheduler not in ("linear", "constant"):
            raise ValueError(f"--scheduler must be linear or constant, got {self.scheduler!r}")
        if self.rng_impl not in ("rbg", "threefry2x32", "unsafe_rbg"):
            raise ValueError(f"invalid --rng_impl {self.rng_impl!r}")
        if self.feature_extract_dtype not in ("default", "bfloat16", "float32"):
            raise ValueError(f"--feature_extract_dtype must be default, "
                             f"bfloat16 or float32, got "
                             f"{self.feature_extract_dtype!r}")
        if not (0.0 <= self.aug_keep_fraction <= 1.0):
            raise ValueError(
                f"--aug_keep_fraction must be in [0, 1] (0 disables the "
                f"gate), got {self.aug_keep_fraction}")
        if not (0.0 <= self.speaker_feat_dropout < 1.0):
            raise ValueError(
                f"--speaker_feat_dropout must be in [0, 1), got "
                f"{self.speaker_feat_dropout}")
        if self.mesh_pp < 1:
            raise ValueError(f"--mesh_pp must be >= 1, got {self.mesh_pp}")
        if self.mesh_pp > 1 and self.mesh_tp > 1:
            raise ValueError("--mesh_pp composes with dp only; drop --mesh_tp")
        if self.mesh_sp < 1:
            raise ValueError(f"--mesh_sp must be >= 1, got {self.mesh_sp}")
        if self.mesh_sp > 1 and (self.mesh_tp > 1 or self.mesh_pp > 1):
            raise ValueError(
                "--mesh_sp composes with dp only; drop --mesh_tp/--mesh_pp")
        if self.mesh_cp < 1:
            raise ValueError(f"--mesh_cp must be >= 1, got {self.mesh_cp}")
        if self.mesh_cp > 1 and (self.mesh_tp > 1 or self.mesh_pp > 1
                                 or self.mesh_sp > 1):
            raise ValueError("--mesh_cp composes with dp only; drop "
                             "--mesh_tp/--mesh_pp/--mesh_sp")
        if self.zero1 and self.mesh_pp > 1:
            raise ValueError(
                "--zero1 applies to the standard pretrain trainer; the "
                "pipeline trainer stage-shards its own optimizer state")
        if self.fsdp and self.mesh_pp > 1:
            raise ValueError(
                "--fsdp applies to the standard pretrain trainer; the "
                "pipeline trainer stage-shards its own parameters")

    @property
    def episode_len(self) -> int:
        # train.py:551-554: 10 with planner supervision, 40 otherwise.
        return 10 if self.path_type == "planner_path" else 40

    def train_batch_size(self, num_devices: int) -> int:
        return self.per_gpu_train_batch_size * num_devices

    # -- (de)serialization -------------------------------------------------
    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls(**json.load(f))

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description="visitron-torch run config")
        for f in dataclasses.fields(cls):
            flag = "--" + f.name
            default = f.default if f.default is not dataclasses.MISSING else None
            if f.type == "bool" or isinstance(default, bool):
                p.add_argument(flag, action="store_true", default=default)
                p.add_argument("--no_" + f.name, dest=f.name, action="store_false")
            elif f.name == "eval_iters":
                p.add_argument(flag, nargs="+", type=int, default=[-1])
            else:
                typ = type(default) if default is not None else str
                p.add_argument(flag, type=typ, default=default)
        return p

    @classmethod
    def from_args(cls, argv=None) -> "RunConfig":
        ns = cls.parser().parse_args(argv)
        return cls(**vars(ns))

    @classmethod
    def cli_overrides(cls, argv) -> dict:
        """Only the flags actually present on the command line (so an explicit
        flag equal to its default still overrides a config-file value)."""
        p = argparse.ArgumentParser(description="visitron-torch config overrides")
        for f in dataclasses.fields(cls):
            flag = "--" + f.name
            default = f.default if f.default is not dataclasses.MISSING else None
            if f.type == "bool" or isinstance(default, bool):
                p.add_argument(flag, action="store_true", default=argparse.SUPPRESS)
                p.add_argument("--no_" + f.name, dest=f.name,
                               action="store_false", default=argparse.SUPPRESS)
            elif f.name == "eval_iters":
                p.add_argument(flag, nargs="+", type=int, default=argparse.SUPPRESS)
            else:
                typ = type(default) if default is not None else str
                p.add_argument(flag, type=typ, default=argparse.SUPPRESS)
        return vars(p.parse_args(argv))


PRETRAIN_AXES = ("mesh_sp", "mesh_cp", "mesh_pp")


def refuse_pretrain_axes(cfg: RunConfig) -> None:
    """The fine-tuning trainers (viewpoint, turn-based, classifier) run
    data and tensor parallelism (``--mesh_dp``, ``--mesh_tp``); sequence,
    context and pipeline parallelism (``--mesh_sp``, ``--mesh_cp``,
    ``--mesh_pp``) are the pretrain task's, and a fine-tuning trainer given
    one refuses it (``run`` drops a value inherited from a config file with
    a warning, as the JAX package ignores it)."""
    for axis in PRETRAIN_AXES:
        if getattr(cfg, axis) > 1:
            raise ValueError(f"--{axis} applies to the pretrain task; use --mesh_tp for "
                             "the fine-tune loops")
