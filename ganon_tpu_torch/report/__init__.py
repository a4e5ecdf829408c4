from ganon_tpu_torch.report.report import report
from ganon_tpu_torch.report.table import table
