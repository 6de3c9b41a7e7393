"""sqlite storage for the web GUI (reference web/app/db.py + schema.sql);
the port's copy of polymer_chemprop_tpu web/db.py.

Tracks users, uploaded datasets, and trained checkpoints. Stdlib sqlite3
only (the reference uses Flask's per-request connection pattern; here one
module-level connection factory with row dicts).
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Any, Dict, List, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS user (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  username TEXT UNIQUE NOT NULL,
  preferences TEXT
);
CREATE TABLE IF NOT EXISTS ckpt (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ckpt_name TEXT NOT NULL,
  associated_user INTEGER NOT NULL,
  created TIMESTAMP NOT NULL DEFAULT CURRENT_TIMESTAMP,
  class TEXT NOT NULL,
  stats TEXT,
  epochs INTEGER NOT NULL DEFAULT 30,
  ensemble_size INTEGER NOT NULL,
  training_size INTEGER NOT NULL,
  completed BOOLEAN NOT NULL DEFAULT 0,
  save_dir TEXT,
  UNIQUE(ckpt_name, associated_user)
);
CREATE TABLE IF NOT EXISTS dataset (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  dataset_name TEXT NOT NULL,
  associated_user INTEGER NOT NULL,
  created TIMESTAMP NOT NULL DEFAULT CURRENT_TIMESTAMP,
  class TEXT NOT NULL,
  path TEXT,
  UNIQUE(dataset_name, associated_user)
);
"""


class WebDB:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "app.sqlite3")
        con = self._connect()
        con.executescript(SCHEMA)
        if not con.execute("SELECT id FROM user").fetchone():
            con.execute("INSERT INTO user (username) VALUES ('default')")
        con.commit()
        con.close()

    def _connect(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.path)
        con.row_factory = sqlite3.Row
        return con

    def query(self, sql: str, params=()) -> List[Dict[str, Any]]:
        con = self._connect()
        try:
            rows = [dict(r) for r in con.execute(sql, params).fetchall()]
            con.commit()
            return rows
        finally:
            con.close()

    def execute(self, sql: str, params=()) -> int:
        con = self._connect()
        try:
            cur = con.execute(sql, params)
            con.commit()
            return cur.lastrowid
        finally:
            con.close()

    # -- users (reference web/app/db.py user CRUD) --------------------------
    def add_user(self, username: str, preferences: str = "") -> int:
        return self.execute(
            "INSERT OR IGNORE INTO user (username, preferences) "
            "VALUES (?, ?)", (username, preferences))

    def users(self) -> List[Dict]:
        return self.query("SELECT * FROM user ORDER BY id")

    def delete_user(self, user_id: int) -> None:
        self.execute("DELETE FROM user WHERE id = ?", (user_id,))

    # -- datasets -----------------------------------------------------------
    def add_dataset(self, name: str, dataset_class: str, path: str,
                    user_id: int = 1) -> int:
        return self.execute(
            "INSERT INTO dataset (dataset_name, associated_user, class, path)"
            " VALUES (?, ?, ?, ?)", (name, user_id, dataset_class, path))

    def datasets(self, user_id: Optional[int] = None) -> List[Dict]:
        if user_id is None:
            return self.query("SELECT * FROM dataset ORDER BY created DESC")
        return self.query(
            "SELECT * FROM dataset WHERE associated_user = ? "
            "ORDER BY created DESC", (user_id,))

    def delete_dataset(self, dataset_id: int) -> None:
        rows = self.query("SELECT path FROM dataset WHERE id = ?",
                          (dataset_id,))
        self.execute("DELETE FROM dataset WHERE id = ?", (dataset_id,))
        for r in rows:
            if r["path"] and os.path.exists(r["path"]):
                os.remove(r["path"])

    # -- checkpoints --------------------------------------------------------
    def add_ckpt(self, name: str, ckpt_class: str, epochs: int,
                 ensemble_size: int, training_size: int, save_dir: str,
                 user_id: int = 1) -> int:
        return self.execute(
            "INSERT INTO ckpt (ckpt_name, associated_user, class, epochs, "
            "ensemble_size, training_size, save_dir) VALUES (?, ?, ?, ?, ?, ?, ?)",
            (name, user_id, ckpt_class, epochs, ensemble_size, training_size,
             save_dir))

    def finish_ckpt(self, ckpt_id: int, stats: Dict) -> None:
        self.execute("UPDATE ckpt SET completed = 1, stats = ? WHERE id = ?",
                     (json.dumps(stats), ckpt_id))

    def ckpts(self, user_id: Optional[int] = None) -> List[Dict]:
        if user_id is None:
            return self.query("SELECT * FROM ckpt ORDER BY created DESC")
        return self.query(
            "SELECT * FROM ckpt WHERE associated_user = ? "
            "ORDER BY created DESC", (user_id,))

    def ckpt(self, ckpt_id: int) -> Optional[Dict]:
        rows = self.query("SELECT * FROM ckpt WHERE id = ?", (ckpt_id,))
        return rows[0] if rows else None

    def delete_ckpt(self, ckpt_id: int) -> None:
        self.execute("DELETE FROM ckpt WHERE id = ?", (ckpt_id,))
