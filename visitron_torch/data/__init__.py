from visitron_torch.data.tokenization import WordPieceTokenizer, build_wordpiece_vocab
from visitron_torch.data.dialog import truncate_dialogs, build_dialog_sequence, SEGMENT_IDS
from visitron_torch.data.datasets import (load_split, NavInstance, build_nav_instances,
                                          load_classifier_episodes)
from visitron_torch.data.classifier_dataset import (ClassifierInstance,
                                                    build_classifier_instances)
from visitron_torch.data.features import (RegionFeatureStore, SceneFeatureTable,
                                          read_tsv_img_features)
from visitron_torch.data.candidates import (
    ScanCandidateTable,
    build_candidate_table,
    build_candidate_tables,
    candidate_angle_features,
    relative_point_id,
)
from visitron_torch.data.env import EnvBatch, SimNavEnv
from visitron_torch.data.legacy_tokenizer import LegacyTokenizer, build_legacy_vocab
from visitron_torch.data.pretrain_dataset import PretrainDataset, PretrainExample

__all__ = [
    "WordPieceTokenizer",
    "build_wordpiece_vocab",
    "truncate_dialogs",
    "build_dialog_sequence",
    "SEGMENT_IDS",
    "load_split",
    "NavInstance",
    "build_nav_instances",
    "load_classifier_episodes",
    "ClassifierInstance",
    "build_classifier_instances",
    "SceneFeatureTable",
    "read_tsv_img_features",
    "ScanCandidateTable",
    "build_candidate_table",
    "build_candidate_tables",
    "candidate_angle_features",
    "relative_point_id",
    "EnvBatch",
    "SimNavEnv",
    "LegacyTokenizer",
    "build_legacy_vocab",
    "RegionFeatureStore",
    "PretrainDataset",
    "PretrainExample",
]
