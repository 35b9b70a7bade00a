"""Interactive front-end (the reference's GUI layer, served over HTTP).

The reference is a desktop app: winit window + pixels framebuffer
(src/main.rs:18-124), an egui settings panel (src/gui.rs:212-339), and an
``Editable`` trait that renders per-type property widgets
(lib/gui/gui.rs:9-92).  An accelerator host has no window, so the
equivalent here is a zero-dependency web viewer: a background render worker
streams progressive passes into an accumulator, and a stdlib HTTP server
serves a single-page UI
whose property panel is generated from :mod:`editable` schemas — the same
type-driven widget idea, over JSON instead of egui.
"""

from .editable import apply_edits, editable_schema, editable_values
from .server import ViewerApp, serve

__all__ = [
    "ViewerApp",
    "apply_edits",
    "editable_schema",
    "editable_values",
    "serve",
]
