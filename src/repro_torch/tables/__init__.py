from repro_torch.tables.table import (
    Column,
    DictEncoding,
    Table,
    catalog_from_numpy,
    civil_from_days,
    days_from_civil,
)

__all__ = ["Column", "Table", "DictEncoding", "catalog_from_numpy",
           "days_from_civil", "civil_from_days"]
