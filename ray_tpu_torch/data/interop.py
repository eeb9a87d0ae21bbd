"""Ecosystem interop: pandas / torch / HuggingFace datasets ⇄ Dataset.

Reference: ray ``python/ray/data/read_api.py`` ``from_pandas`` /
``from_torch`` / ``from_huggingface`` and ``Dataset.to_pandas``.  All
three bridge through the columnar block (numpy columns), so numeric data
round-trips without per-row materialization; the HuggingFace path rides
the existing Arrow zero-copy bridge (HF datasets are Arrow-backed).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Union

if TYPE_CHECKING:  # pragma: no cover
    import pandas as pd


def from_pandas(dfs: Union["pd.DataFrame", List["pd.DataFrame"]],
                parallelism: int = 8):
    """DataFrame(s) → Dataset of ColumnarBlocks.  Numeric columns wrap the
    frame's numpy arrays directly; a single frame is split into up to
    ``parallelism`` blocks so downstream transforms parallelize."""
    import pandas as pd

    from .block import ColumnarBlock
    from .dataset import from_blocks

    if isinstance(dfs, pd.DataFrame):
        n = len(dfs)
        k = max(1, min(parallelism, n or 1))
        size = (n + k - 1) // k
        dfs = [dfs.iloc[i * size:(i + 1) * size] for i in range(k)
               if i * size < n] or [dfs]
    blocks = []
    for df in dfs:
        cols = {}
        for name in df.columns:
            series = df[name]
            arr = series.to_numpy()
            cols[str(name)] = arr
        blocks.append(ColumnarBlock(cols))
    return from_blocks(blocks)


def dataset_to_pandas(ds) -> "pd.DataFrame":
    """Materialize a Dataset as ONE DataFrame (via the Arrow bridge, so
    primitive columns move zero-copy Block→Table→frame)."""
    from .arrow import dataset_to_arrow

    return dataset_to_arrow(ds).to_pandas()


def from_torch(torch_dataset, parallelism: int = 8):
    """Map-style ``torch.utils.data.Dataset`` → Dataset (reference
    ``torch_datasource.py``).  Index ranges shard across read tasks; the
    torch dataset itself is pickled to each task, so items load inside
    workers, not on the driver.  Items become ``{"item": x}`` rows
    (tensors convert to numpy); iterable-style datasets materialize in
    one task since they can't be index-sharded."""
    from .dataset import read_datasource
    from .datasource import Datasource, ReadTask

    class _TorchDatasource(Datasource):
        def get_read_tasks(self, k):
            def fetch(lo, hi):
                out = []
                for i in range(lo, hi):
                    out.append({"item": _to_numpy(torch_dataset[i])})
                return out

            try:
                n = len(torch_dataset)
            except TypeError:
                # Iterable-style: single sequential pass.
                return [ReadTask(
                    lambda: [{"item": _to_numpy(x)} for x in torch_dataset],
                    {},
                )]
            k = max(1, min(k, n or 1))
            size = (n + k - 1) // k
            return [
                ReadTask(lambda a=i * size, b=min((i + 1) * size, n):
                         fetch(a, b), {"num_rows": min((i + 1) * size, n) - i * size})
                for i in range(k) if i * size < n
            ]

    return read_datasource(_TorchDatasource(), parallelism)


def _to_numpy(x):
    try:
        import torch

        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, (tuple, list)):
            return type(x)(_to_numpy(v) for v in x)
        if isinstance(x, dict):
            return {k: _to_numpy(v) for k, v in x.items()}
    except ImportError:  # pragma: no cover
        pass
    return x


def from_huggingface(hf_dataset, parallelism: int = 8):
    """HuggingFace ``datasets.Dataset`` → Dataset via its Arrow table
    (reference ``huggingface_datasource.py``).  Zero-copy for primitive
    columns; the table is sliced into up to ``parallelism`` blocks."""
    from .arrow import arrow_to_block
    from .dataset import from_blocks

    table = getattr(hf_dataset.data, "table", None)
    if table is None:  # pragma: no cover — older datasets versions
        table = hf_dataset.data
    table = table.combine_chunks()
    n = table.num_rows
    k = max(1, min(parallelism, n or 1))
    size = (n + k - 1) // k
    blocks = [
        arrow_to_block(table.slice(i * size, size))
        for i in range(k) if i * size < n
    ] or [arrow_to_block(table)]
    return from_blocks(blocks)
