"""Web GUI of the port (stdlib http.server + sqlite3; reference
chemprop/web uses Flask)."""

from .app import AppState, build_app, chemprop_web, run_web
from .db import WebDB

__all__ = ["AppState", "WebDB", "build_app", "chemprop_web", "run_web"]
