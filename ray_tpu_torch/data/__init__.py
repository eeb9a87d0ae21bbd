from .aggregate import (  # noqa: F401
    AggregateFn,
    Count,
    GroupedData,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from .datasource import Datasource, ReadTask  # noqa: F401
from .execution import ActorPoolStrategy  # noqa: F401
from .streaming import ExecutionOptions  # noqa: F401
from .arrow import from_arrow  # noqa: F401
from .interop import from_huggingface, from_pandas, from_torch  # noqa: F401
from .datasink import (  # noqa: F401
    AvroDatasink,
    CSVDatasink,
    Datasink,
    ImageDatasink,
    JSONDatasink,
    ManifestedDatasink,
    NumpyDatasink,
    ParquetDatasink,
    SQLDatasink,
    TFRecordsDatasink,
    WebDatasetDatasink,
)
from .warehouse import (  # noqa: F401
    BigQueryDatasource,
    ClickHouseDatasource,
    IcebergDatasource,
    KafkaDatasink,
    KafkaDatasource,
    MongoDatasink,
    MongoDatasource,
)
from .dataset import (  # noqa: F401
    DataIterator,
    Dataset,
    from_blocks,
    from_items,
    range_dataset,
    read_audio,
    read_avro,
    read_binary_files,
    read_images,
    read_bigquery,
    read_clickhouse,
    read_iceberg,
    read_kafka,
    read_mongo,
    read_sql,
    read_tfrecords,
    read_videos,
    read_webdataset,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)
