"""List loading: CSV files of String/Int/Ip items for rule expressions.

Reference parity (pingoo/lists.rs:48-125): lists are CSV with 1 value
column and an optional description column; values are trimmed; Int parses
as i64; Ip parses as an address or CIDR network (IpNetwork); all lists are
exposed to expressions as one `lists` map variable whose values are typed
arrays (lists.rs:115-125, used as `lists["blocked_ips"].contains(client.ip)`
per docs/rules.md:110).

The loaded representation is the interpreter's value model; the compiler
(compiler/plan.py) separately lowers these into device tables (bitsets,
v4 buckets, CIDR tables).
"""

from __future__ import annotations

import csv
import io
from typing import Iterable

from .config.schema import ConfigError, ListConfig, ListType
from .expr import Ip
from .expr.values import I64_MAX, I64_MIN


def load_lists(lists_config: Iterable[ListConfig]) -> dict[str, list]:
    """Load every configured list into the `lists` expression variable."""
    lists: dict[str, list] = {}
    for cfg in lists_config:
        try:
            with open(cfg.file, "r", encoding="utf-8") as f:
                content = f.read()
        except OSError as exc:
            raise ConfigError(f"error reading list {cfg.file}: {exc}")
        lists[cfg.name] = parse_list(content, cfg.type, path=cfg.file)
    return lists


def parse_list(content: str, list_type: ListType, path: str = "<memory>") -> list:
    """Parse CSV content into a typed item list (reference lists.rs:62-113)."""
    items: list = []
    reader = csv.reader(io.StringIO(content))
    for line_number, record in enumerate(reader, start=1):
        if not record:
            continue
        if len(record) > 2:
            raise ConfigError(
                f"error parsing list {path} at line {line_number}: invalid "
                "number of columns. Min: 1, Max: 2"
            )
        value = record[0].strip()
        if list_type == ListType.STRING:
            items.append(value)
        elif list_type == ListType.INT:
            try:
                parsed = int(value, 10)
            except ValueError:
                raise ConfigError(
                    f"error parsing list {path} at line {line_number}: error parsing int"
                )
            if not (I64_MIN <= parsed <= I64_MAX):
                raise ConfigError(
                    f"error parsing list {path} at line {line_number}: int out of range"
                )
            items.append(parsed)
        else:
            try:
                items.append(Ip(value))
            except Exception:
                raise ConfigError(
                    f"error parsing list {path} at line {line_number}: error "
                    "parsing IP network"
                )
    return items
