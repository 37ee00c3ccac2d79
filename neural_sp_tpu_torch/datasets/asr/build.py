"""build_dataloader (counterpart of ``neural_sp_tpu/datasets/asr/
build.py``): a dataset and its loader from the CLI's settings. Frame
stacking and splicing raise when set; the JAX loader's sub-task label
streams and alignment directories have no parameter here (the train CLI
raises on their flags)."""
from __future__ import annotations

from .dataloader import ASRDataLoader
from .dataset import ASRDataset


def build_dataloader(
    tsv_path: str,
    dict_path: str,
    unit: str = "char",
    wp_model: str | None = None,
    batch_size: int = 1,
    batch_size_type: str = "seq",
    dynamic_batching: bool = False,
    bucketing: str = "sort",
    min_n_frames: int = 1,
    max_n_frames: int = 10**9,
    subsample_factor: int = 1,
    is_test: bool = False,
    short2long: bool = True,
    seed: int = 1,
    pad_xlen_multiple: int = 16,
    pad_ylen_multiple: int = 8,
    pad_batch_multiple: int = 1,
    sort_stop_epoch: int = 10000,
    n_stacks: int = 1,
    n_skips: int = 1,
    n_splices: int = 1,
) -> ASRDataLoader:
    if max(n_stacks, n_skips, n_splices) > 1:
        raise NotImplementedError(
            "frame stacking and splicing are not ported yet, see ROADMAP")
    dataset = ASRDataset(
        tsv_path=tsv_path, dict_path=dict_path, unit=unit, wp_model=wp_model,
        min_n_frames=min_n_frames, max_n_frames=max_n_frames,
        subsample_factor=subsample_factor, is_test=is_test,
        short2long=short2long)
    return ASRDataLoader(
        dataset, batch_size=batch_size, batch_size_type=batch_size_type,
        dynamic_batching=dynamic_batching, bucketing=bucketing, seed=seed,
        pad_xlen_multiple=pad_xlen_multiple,
        pad_ylen_multiple=pad_ylen_multiple,
        pad_batch_multiple=pad_batch_multiple,
        sort_stop_epoch=sort_stop_epoch)
