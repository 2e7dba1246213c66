"""Serving layer: WSGI app + job queue + SVG rendering (reference L7,
`MMT_website/Runfolder/` — see serve/app.py for the route map)."""

from .app import DEFAULT_PORT, ServerState, make_app, serve  # noqa: F401
from .jobs import Job, JobQueue  # noqa: F401
