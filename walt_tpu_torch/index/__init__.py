from walt_tpu_torch.index.build import HashTable, build_table, build_all_tables  # noqa: F401
from walt_tpu_torch.index import io_walt  # noqa: F401
