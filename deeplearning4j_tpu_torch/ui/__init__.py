"""UI of the port (≡ deeplearning4j-ui): the dashboard and the operations
endpoints of `UIServer`, the training statistics of `StatsListener` and its
storages (`ui/stats.py`), and `render_static_html`."""
from deeplearning4j_tpu_torch.ui.stats import (FileStatsStorage,
                                               InMemoryStatsStorage,
                                               StatsListener)
from deeplearning4j_tpu_torch.ui.server import UIServer, render_static_html

__all__ = ["FileStatsStorage", "InMemoryStatsStorage", "StatsListener",
           "UIServer", "render_static_html"]
