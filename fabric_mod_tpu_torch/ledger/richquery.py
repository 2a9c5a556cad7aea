"""Rich (JSON-document) state queries.

The port's copy of fabric_mod_tpu/ledger/richquery.py (reference: core/ledger/kvledger/txmgmt/statedb/statecouchdb/
statecouchdb.go:1230 ExecuteQuery — Fabric delegates selector
evaluation to CouchDB's Mango engine; this module implements the same
query surface natively so rich queries work against our versioned
state DBs without an external document store.)

Semantics mirrored from the reference:
* Values that are not JSON objects simply never match a selector
  (CouchDB indexes only JSON documents).
* Rich query results are NOT protected against phantoms at validation
  time — like the reference, which documents that chaincode rich
  queries are not re-executed at commit; the individual returned keys
  ARE added to the read set (statecouchdb query executor behavior).
* Pagination via `limit` + an opaque `bookmark` that continues after
  the last returned key (statecouchdb.go's bookmark contract).

Selector language (the Mango core): implicit equality
`{"owner": "alice"}`, operators `$eq $ne $gt $gte $lt $lte $in $nin
$exists $not $and $or $nor`, nested fields via dotted paths.
`use_index` is accepted and ignored (our scan is the index); `fields`
projects the returned documents; `sort` orders by dotted field paths.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple


class QueryError(Exception):
    pass


_OPS = frozenset(("$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in",
                  "$nin", "$exists", "$not", "$and", "$or", "$nor"))


def _field(doc: Any, path: str):
    """Resolve a dotted path; (found, value)."""
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return False, None
        cur = cur[part]
    return True, cur


def _cmp_ok(a, b) -> bool:
    """CouchDB compares only like types; cross-type comparisons never
    match rather than raising."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return True
    return type(a) is type(b)


def _match_cond(value_found: bool, value, cond) -> bool:
    """One field condition: either a bare value (equality) or an
    operator object like {"$gt": 5}."""
    if isinstance(cond, dict) and \
            any(isinstance(k, str) and k.startswith("$") for k in cond):
        for op, operand in cond.items():
            if op == "$exists":
                if bool(operand) != value_found:
                    return False
            elif op == "$not":
                if _match_cond(value_found, value, operand):
                    return False
            elif op == "$eq":
                if not (value_found and value == operand):
                    return False
            elif op == "$ne":
                if value_found and value == operand:
                    return False
            elif op in ("$gt", "$gte", "$lt", "$lte"):
                if not value_found or not _cmp_ok(value, operand):
                    return False
                if op == "$gt" and not value > operand:
                    return False
                if op == "$gte" and not value >= operand:
                    return False
                if op == "$lt" and not value < operand:
                    return False
                if op == "$lte" and not value <= operand:
                    return False
            elif op == "$in":
                if not (value_found and isinstance(operand, list)
                        and value in operand):
                    return False
            elif op == "$nin":
                if value_found and isinstance(operand, list) and \
                        value in operand:
                    return False
            else:
                raise QueryError(f"unsupported operator {op!r}")
        return True
    return value_found and value == cond


def match_selector(doc: Any, selector: Dict) -> bool:
    """Does `doc` satisfy the Mango selector?"""
    if not isinstance(selector, dict):
        raise QueryError("selector must be an object")
    for key, cond in selector.items():
        if key == "$and":
            if not all(match_selector(doc, s) for s in cond):
                return False
        elif key == "$or":
            if not any(match_selector(doc, s) for s in cond):
                return False
        elif key == "$nor":
            if any(match_selector(doc, s) for s in cond):
                return False
        elif key == "$not":
            if match_selector(doc, cond):
                return False
        elif key.startswith("$"):
            raise QueryError(f"unsupported operator {key!r}")
        else:
            found, value = _field(doc, key)
            if not _match_cond(found, value, cond):
                return False
    return True


def _sort_key(doc, sort_spec: List):
    parts = []
    for entry in sort_spec:
        if isinstance(entry, dict):
            [(path, _direction)] = entry.items()
        else:
            path = entry
        found, v = _field(doc, path)
        # sort missing fields first, group values by type name so
        # heterogeneous values order deterministically
        parts.append((not found,
                      type(v).__name__ if found else "",
                      v if found and not isinstance(v, (dict, list))
                      else json.dumps(v, sort_keys=True) if found else ""))
    return tuple(parts)


def _project(doc, fields: Optional[List[str]]):
    if not fields:
        return doc
    out: Dict = {}
    for path in fields:
        found, v = _field(doc, path)
        if not found:
            continue
        cur = out
        parts = path.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


class RichQuery:
    """A parsed query: selector + sort/limit/bookmark/fields."""

    def __init__(self, selector: Dict, sort: Optional[List] = None,
                 limit: Optional[int] = None, bookmark: str = "",
                 fields: Optional[List[str]] = None):
        self.selector = selector
        self.sort = sort
        self.limit = limit
        self.bookmark = bookmark
        self.fields = fields

    @classmethod
    def parse(cls, query) -> "RichQuery":
        if isinstance(query, (bytes, str)):
            try:
                query = json.loads(query)
            except Exception as e:
                raise QueryError(f"bad query JSON: {e}") from e
        if not isinstance(query, dict) or "selector" not in query:
            raise QueryError("query must carry a 'selector'")
        limit = query.get("limit")
        if limit is not None and (not isinstance(limit, int) or limit < 0):
            raise QueryError("limit must be a non-negative integer")
        sort = query.get("sort")
        if sort is not None and not isinstance(sort, list):
            raise QueryError("sort must be a list")
        fields = query.get("fields")
        if fields is not None and not isinstance(fields, list):
            raise QueryError("fields must be a list")
        # use_index accepted and ignored (scan IS the index here)
        return cls(query["selector"], sort, limit,
                   str(query.get("bookmark", "") or ""), fields)


def execute(rows: Iterable[Tuple[str, bytes, tuple]], query: RichQuery
            ) -> Tuple[List[Tuple[str, Any, tuple]], str]:
    """Run a parsed query over (key, value_bytes, version) rows in key
    order.  Returns (matches as (key, projected_doc, version), next
    bookmark).  The bookmark is the last returned key; passing it back
    continues strictly after it — only valid for unsorted queries
    (sorted pagination would need the full result anyway, matching
    CouchDB's stable-sort bookmark limits)."""
    if query.sort and query.bookmark:
        raise QueryError("bookmark pagination requires an unsorted query")
    matches: List[Tuple[str, Any, tuple]] = []
    limit = query.limit
    if limit == 0:
        return [], ""
    for key, raw, ver in rows:
        if query.bookmark and key <= query.bookmark:
            continue
        try:
            doc = json.loads(raw)
        except Exception:
            continue                       # non-JSON values never match
        if not match_selector(doc, query.selector):
            continue
        matches.append((key, doc, ver))
        if limit is not None and not query.sort and \
                len(matches) >= limit:
            break                          # early exit: scan no further
    if query.sort:
        directions = {list(e.values())[0] if isinstance(e, dict)
                      else "asc" for e in query.sort}
        if len(directions) > 1:
            # CouchDB's same rule: one direction for the whole sort
            raise QueryError("sort fields must share one direction")
        matches.sort(key=lambda kv: _sort_key(kv[1], query.sort),
                     reverse=(directions == {"desc"}))
        if limit is not None:
            matches = matches[:limit]
    # sorted queries cannot be continued (passing a bookmark back is
    # rejected above): return an empty bookmark so clients can detect
    # pagination is unavailable instead of erroring on page 2
    bookmark = matches[-1][0] if matches and not query.sort else ""
    if query.fields:
        matches = [(k, _project(d, query.fields), v)
                   for k, d, v in matches]
    return matches, bookmark
