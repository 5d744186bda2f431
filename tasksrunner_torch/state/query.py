"""The state query dialect: the port of ``tasksrunner/state/query.py``.

The JSON the reference's API service sends through ``QueryStateAsync``
(an EQ on ``taskCreatedBy``; an EQ on a serialised date)::

    {
      "filter": {"EQ": {"<path>": <value>}} | {"NEQ": {...}}
              | {"IN": {"<path>": [v, ...]}}
              | {"AND": [<filter>, ...]} | {"OR": [<filter>, ...]} | {},
      "sort":  [{"key": "<path>", "order": "ASC" | "DESC"}, ...],
      "page":  {"limit": N, "token": "<opaque>"}
    }

A path addresses the stored JSON document with dots (``address.city``);
a missing field reads as null, so it matches ``EQ null`` and ``IN
[null]``. Values compare as JSON values: strings as strings, so a date
matches only in the format it was saved in. A sort orders null before
numbers, numbers before strings and strings before containers, as
sqlite orders ``json_extract``; a page token is the decimal offset of
the next item. The in-memory store runs :func:`run_query`; the sqlite
store compiles the same dialect to SQL
(:func:`tasksrunner_torch.state.sqlite.compile_filter`) and must answer
the same.
"""

from __future__ import annotations

import functools
import json
from typing import Any

from tasksrunner_torch.errors import QueryError

_FILTER_OPS = ("EQ", "NEQ", "IN", "AND", "OR")


def get_path(doc: Any, path: str) -> Any:
    """``a.b.c`` of a JSON document; None where it is absent."""
    node = doc
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node


def _single_entry(mapping: Any, op: str) -> tuple[str, Any]:
    if not isinstance(mapping, dict) or len(mapping) != 1:
        raise QueryError(f"{op} filter must hold exactly one path entry")
    return next(iter(mapping.items()))


def _require_scalar(value: Any, op: str) -> None:
    # a container cannot be bound as an SQL parameter: refused here, so
    # that the two engines never differ
    if isinstance(value, (dict, list)):
        raise QueryError(f"{op} comparison values must be scalars, not {type(value).__name__}")


def validate_filter(filt: Any) -> None:
    """Raise :class:`QueryError` on a malformed filter."""
    if filt in (None, {}):
        return
    if not isinstance(filt, dict) or len(filt) != 1:
        raise QueryError("filter must hold exactly one operator")
    op, operand = next(iter(filt.items()))
    if op not in _FILTER_OPS:
        raise QueryError(f"unknown filter operator {op!r} (expected one of {_FILTER_OPS})")
    if op in ("AND", "OR"):
        if not isinstance(operand, list) or not operand:
            raise QueryError(f"{op} expects a non-empty list of sub-filters")
        for sub in operand:
            validate_filter(sub)
    elif op == "IN":
        _, values = _single_entry(operand, op)
        if not isinstance(values, list):
            raise QueryError("IN expects a list of candidate values")
        for v in values:
            _require_scalar(v, op)
    else:
        _, v = _single_entry(operand, op)
        _require_scalar(v, op)


def matches(doc: Any, filt: Any) -> bool:
    """Whether ``doc`` passes the (validated) filter."""
    if filt in (None, {}):
        return True
    op, operand = next(iter(filt.items()))
    if op == "AND":
        return all(matches(doc, sub) for sub in operand)
    if op == "OR":
        return any(matches(doc, sub) for sub in operand)
    path, expected = _single_entry(operand, op)
    actual = get_path(doc, path)
    if op == "EQ":
        return actual == expected
    if op == "NEQ":
        return actual != expected
    if op == "IN":
        return actual in expected
    raise QueryError(f"unknown filter operator {op!r}")


def _sort_rank(v: Any) -> int:
    """sqlite's storage-class order: NULL < numeric < text < the rest."""
    if v is None:
        return 0
    if isinstance(v, (bool, int, float)):
        return 1
    if isinstance(v, str):
        return 2
    return 3


def _sort_cmp(a: Any, b: Any) -> int:
    if a == b:
        return 0
    ra, rb = _sort_rank(a), _sort_rank(b)
    if ra != rb:
        return -1 if ra < rb else 1
    if ra == 3:
        # containers have no order of their own: their canonical JSON text
        a, b = json.dumps(a, sort_keys=True), json.dumps(b, sort_keys=True)
        if a == b:
            return 0
    return -1 if a < b else 1


def sort_clauses(sort_spec: list | None) -> list[tuple[str, str]]:
    """(path, ``ASC`` | ``DESC``) of each clause, validated."""
    clauses = []
    for clause in sort_spec or []:
        if not isinstance(clause, dict) or "key" not in clause:
            raise QueryError("each sort clause needs a key")
        order = str(clause.get("order", "ASC")).upper()
        if order not in ("ASC", "DESC"):
            raise QueryError(f"sort order must be ASC or DESC, not {clause.get('order')!r}")
        clauses.append((clause["key"], order))
    return clauses


def sort_items(items: list, sort_spec: list[dict] | None) -> list:
    """A stable sort, the leftmost clause the primary key."""
    clauses = sort_clauses(sort_spec)
    out = list(items)
    for path, order in reversed(clauses):
        out.sort(key=functools.cmp_to_key(
            lambda x, y, p=path: _sort_cmp(get_path(x.value, p), get_path(y.value, p))),
            reverse=order == "DESC")
    return out


def page_window(page: dict | None) -> tuple[int, int | None]:
    """(offset, limit) of a page spec; a None limit is everything after
    the offset."""
    page = page or {}
    limit, token = page.get("limit"), page.get("token")
    start = 0
    if token is not None:
        try:
            start = int(token)
        except (TypeError, ValueError):
            raise QueryError(f"bad page token {token!r}") from None
        if start < 0:
            raise QueryError(f"bad page token {token!r}")
    if limit is not None and (not isinstance(limit, int) or limit <= 0):
        raise QueryError("page.limit must be a positive integer")
    return start, limit


def paginate(items: list, page: dict | None) -> tuple[list, str | None]:
    """One page and the next page's token (None after the last)."""
    if not page:
        return items, None
    start, limit = page_window(page)
    if limit is None:
        return items[start:], None
    chunk = items[start:start + limit]
    return chunk, str(start + limit) if start + limit < len(items) else None


def run_query(items: list, query: dict):
    """Filter, sort and page materialised items: (page, next token)."""
    if not isinstance(query, dict):
        raise QueryError("query must be a JSON object")
    filt = query.get("filter")
    validate_filter(filt)
    hits = [it for it in items if matches(it.value, filt)]
    hits = sort_items(hits, query.get("sort"))
    return paginate(hits, query.get("page"))
