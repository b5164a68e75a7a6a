"""UI of the port (≡ deeplearning4j-ui): the dashboard and the operations
endpoints of `UIServer`. `ui/stats.py` (`StatsListener` and its
storages) and `render_static_html` come with ROADMAP A17: until then
`/stats` serves any attached object with an `.all()` of JSON records."""
from deeplearning4j_tpu_torch.ui.server import UIServer

__all__ = ["UIServer"]
