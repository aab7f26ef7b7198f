"""GraphQL API: hand-rolled executor for the reference's GraphQL surface;
the port's copy of ``nornicdb_tpu/server/graphql.py``.

Behavioral reference: the upstream NornicDB pkg/graphql/ — gqlgen-based schema with
node/edge CRUD, search, Cypher pass-through and traversals (handler.go,
schema/, resolvers/). graphql-core is not in this image, so this module
implements a small GraphQL subset natively: query/mutation operations,
field arguments (literals + $variables with defaults), nested selection
sets (projected onto results), aliases, named + inline fragments,
@include/@skip directives, __typename, and enough of the introspection
schema (__schema/__type) for clients that probe capabilities.

Root fields:
  query:    node(id) nodes(label, limit) relationships(type, limit)
            search(query, limit) similar(id, limit) cypher(statement,
            parameters) neighbors(id, depth) stats
  mutation: createNode(labels, properties) updateNode(id, properties)
            deleteNode(id) createRelationship(from, to, type, properties)
            deleteRelationship(id)

Where it differs from the JAX package: a field that raises
``DeviceUnavailable`` (the card is not serving) is not turned into a
per-field error. It propagates out of ``GraphQLExecutor.execute``, so the
HTTP edge answers 503 with ``Retry-After``, as it does for every other
route. Every other exception of a field stays a per-field error.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Optional

from nornicdb_tpu_torch.errors import (
    CypherSyntaxError,
    DeviceUnavailable,
    NornicError,
)
from nornicdb_tpu_torch.storage.types import Edge, Node

_TOKEN = re.compile(
    r"""(?P<ws>[\s,]+|\#[^\n]*)|(?P<name>[_A-Za-z][_0-9A-Za-z]*)"""
    r"""|(?P<string>"(?:\\.|[^"\\])*")|(?P<float>-?\d+\.\d+)"""
    r"""|(?P<int>-?\d+)|(?P<punct>[{}()\[\]:$=!@])|(?P<spread>\.\.\.)"""
)


class _Parser:
    def __init__(self, src: str):
        self.tokens = []
        last_end = 0
        for m in _TOKEN.finditer(src):
            if m.start() != last_end:
                raise CypherSyntaxError(
                    f"GraphQL: unexpected character {src[last_end]!r}"
                )
            last_end = m.end()
            kind = m.lastgroup
            if kind != "ws":
                self.tokens.append((kind, m.group(0)))
        if last_end != len(src):
            raise CypherSyntaxError(
                f"GraphQL: unexpected character {src[last_end]!r}"
            )
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else ("eof", "")

    def next(self):
        t = self.peek()
        if t[0] == "eof":
            raise CypherSyntaxError("GraphQL: unexpected end of query")
        self.pos += 1
        return t

    def expect(self, value: str):
        kind, v = self.next()
        if v != value:
            raise CypherSyntaxError(f"GraphQL: expected {value!r}, got {v!r}")

    def parse_document(self) -> dict:
        """Full document: one operation + any number of named fragments."""
        operation = None
        fragments: dict[str, dict] = {}
        while self.peek()[0] != "eof":
            kind, v = self.peek()
            if v == "fragment":
                self.next()
                fname = self.next()[1]
                self.expect("on")
                ftype = self.next()[1]
                fragments[fname] = {
                    "type": ftype,
                    "selections": self.parse_selection_set(),
                }
            else:
                op = self.parse_operation_def()
                if operation is not None:
                    raise CypherSyntaxError(
                        "GraphQL: multiple operations in one document"
                    )
                operation = op
        if operation is None:
            raise CypherSyntaxError("GraphQL: no operation in document")
        operation["fragments"] = fragments
        return operation

    def parse_operation_def(self) -> dict:
        kind, v = self.peek()
        op = "query"
        name = None
        var_defaults: dict[str, Any] = {}
        if v in ("query", "mutation"):
            op = v
            self.next()
            if self.peek()[0] == "name":
                name = self.next()[1]
            if self.peek()[1] == "(":
                self.next()
                while self.peek()[1] != ")":
                    self.expect("$")
                    vname = self.next()[1]
                    self.expect(":")
                    # type tokens (Name, [Name!]!, …): consume until the next
                    # variable, a default marker, or the close paren
                    consumed = 0
                    while self.peek()[1] not in ("=", ")", "$"):
                        tk, tv = self.next()
                        if tk != "name" and tv not in ("[", "]", "!"):
                            raise CypherSyntaxError(
                                f"GraphQL: bad variable type near {tv!r}"
                            )
                        consumed += 1
                    if consumed == 0:
                        raise CypherSyntaxError(
                            f"GraphQL: missing type for ${vname}"
                        )
                    if self.peek()[1] == "=":
                        self.next()
                        var_defaults[vname] = self.parse_value()
                self.expect(")")
        selections = self.parse_selection_set()
        return {
            "operation": op,
            "name": name,
            "selections": selections,
            "var_defaults": var_defaults,
        }

    def parse_selection_set(self) -> list[dict]:
        self.expect("{")
        out = []
        while self.peek()[1] != "}":
            out.append(self.parse_field())
        self.expect("}")
        return out

    def parse_field(self) -> dict:
        kind, name = self.next()
        if kind == "spread":
            # ...FragmentName | ... on Type { ... }
            nk, nv = self.peek()
            if nv == "on":
                self.next()
                ftype = self.next()[1]
                directives = self.parse_directives()
                return {"inline": ftype, "directives": directives,
                        "selections": self.parse_selection_set()}
            if nk != "name":
                raise CypherSyntaxError("GraphQL: expected fragment name after '...'")
            fname = self.next()[1]
            return {"spread": fname, "directives": self.parse_directives()}
        if kind != "name":
            raise CypherSyntaxError(f"GraphQL: expected field name, got {name!r}")
        alias = None
        if self.peek()[1] == ":":
            self.next()
            alias, name = name, self.next()[1]
        args = {}
        if self.peek()[1] == "(":
            self.next()
            while self.peek()[1] != ")":
                akind, aname = self.next()
                self.expect(":")
                args[aname] = self.parse_value()
            self.expect(")")
        directives = self.parse_directives()
        sub = None
        if self.peek()[1] == "{":
            sub = self.parse_selection_set()
        return {"name": name, "alias": alias or name, "args": args,
                "directives": directives, "selections": sub}

    def parse_directives(self) -> list[dict]:
        out = []
        while self.peek()[1] == "@":
            self.next()
            dname = self.next()[1]
            dargs = {}
            if self.peek()[1] == "(":
                self.next()
                while self.peek()[1] != ")":
                    ak, an = self.next()
                    self.expect(":")
                    dargs[an] = self.parse_value()
                self.expect(")")
            out.append({"name": dname, "args": dargs})
        return out

    def parse_value(self) -> Any:
        kind, v = self.next()
        if kind == "string":
            return json.loads(v)
        if kind == "int":
            return int(v)
        if kind == "float":
            return float(v)
        if kind == "name":
            if v == "true":
                return True
            if v == "false":
                return False
            if v == "null":
                return None
            return v  # enum-ish
        if v == "$":
            return _Var(self.next()[1])
        if v == "[":
            out = []
            while self.peek()[1] != "]":
                out.append(self.parse_value())
            self.next()
            return out
        if v == "{":
            out = {}
            while self.peek()[1] != "}":
                k = self.next()[1]
                self.expect(":")
                out[k] = self.parse_value()
            self.next()
            return out
        raise CypherSyntaxError(f"GraphQL: unexpected value token {v!r}")


class _Var:
    def __init__(self, name: str):
        self.name = name

    def __eq__(self, other):  # same $var in two selections must merge cleanly
        return isinstance(other, _Var) and other.name == self.name

    def __hash__(self):
        return hash(("_Var", self.name))


# document memo (same rationale as the Cypher AST memo, cypher/parser.py:1127:
# re-parsing identical documents dominated repeat-query time; parsed docs are
# execution-immutable — merging/flattening copies selection dicts before
# mutating). Epoch eviction: clear at cap, zero bookkeeping on hits.
_DOC_CACHE: dict[str, dict] = {}
_DOC_LOCK = threading.Lock()
_DOC_CACHE_MAX = 256


def parse_document_cached(query: str) -> dict:
    with _DOC_LOCK:
        doc = _DOC_CACHE.get(query)
    if doc is not None:
        return doc
    doc = _Parser(query).parse_document()
    with _DOC_LOCK:
        if len(_DOC_CACHE) >= _DOC_CACHE_MAX:
            _DOC_CACHE.clear()
        _DOC_CACHE[query] = doc
    return doc


def parse_operation(query: str) -> str:
    """Operation type of a document ("query"/"mutation"); "query" on parse
    failure (the executor will produce the real error)."""
    try:
        return parse_document_cached(query)["operation"]
    except Exception:  # nornlint: disable=NL-ERR02
        return "query"


def _resolve_args(args: dict, variables: dict) -> dict:
    def res(v):
        if isinstance(v, _Var):
            return variables.get(v.name)
        if isinstance(v, list):
            return [res(x) for x in v]
        if isinstance(v, dict):
            return {k: res(x) for k, x in v.items()}
        return v

    return {k: res(v) for k, v in args.items()}


def _node_obj(n: Node) -> dict:
    return {
        "__typename": "Node",
        "id": n.id,
        "labels": list(n.labels),
        "properties": dict(n.properties),
        "decayScore": n.decay_score,
        "accessCount": n.access_count,
    }


def _edge_obj(e: Edge) -> dict:
    return {
        "__typename": "Relationship",
        "id": e.id,
        "type": e.type,
        "from": e.start_node,
        "to": e.end_node,
        "properties": dict(e.properties),
        "confidence": e.confidence,
        "autoGenerated": e.auto_generated,
    }


def _directive_allows(directives: list[dict], variables: dict) -> bool:
    """Evaluate @include(if:)/@skip(if:) (the two spec-mandated directives).
    A missing `if` or undefined variable is an error, not a silent drop —
    the spec types `if` as Boolean! and undefined variables fail validation."""
    for d in directives or []:
        if d["name"] not in ("include", "skip"):
            continue  # unknown directives are ignored, matching lenient servers
        if "if" not in d["args"]:
            raise CypherSyntaxError(
                f"GraphQL: @{d['name']} requires an 'if' argument"
            )
        cond = d["args"]["if"]
        if isinstance(cond, _Var):
            if cond.name not in variables:
                raise CypherSyntaxError(
                    f"GraphQL: undefined variable ${cond.name} in @{d['name']}"
                )
            cond = variables[cond.name]
        if d["name"] == "include" and not cond:
            return False
        if d["name"] == "skip" and cond:
            return False
    return True


def _flatten_selections(
    selections: list[dict],
    fragments: dict[str, dict],
    variables: dict,
    typename: Optional[str],
    _depth: int = 0,
) -> list[dict]:
    """Expand fragment spreads / inline fragments into plain fields,
    honoring type conditions and @include/@skip."""
    if _depth > 16:
        raise CypherSyntaxError("GraphQL: fragment nesting too deep (cycle?)")
    out: list[dict] = []
    for sel in selections:
        if not _directive_allows(sel.get("directives"), variables):
            continue
        if "spread" in sel:
            frag = fragments.get(sel["spread"])
            if frag is None:
                raise CypherSyntaxError(
                    f"GraphQL: unknown fragment {sel['spread']!r}"
                )
            if typename is None or frag["type"] == typename:
                out.extend(_flatten_selections(
                    frag["selections"], fragments, variables, typename,
                    _depth + 1))
        elif "inline" in sel:
            if typename is None or sel["inline"] == typename:
                out.extend(_flatten_selections(
                    sel["selections"], fragments, variables, typename,
                    _depth + 1))
        else:
            out.append(sel)
    return _merge_fields(out)


def _merge_fields(selections: list[dict]) -> list[dict]:
    """Spec field merging: same response key selected twice (the normal
    composed-fragments pattern) concatenates sub-selections instead of
    last-wins, and the resolver runs once per key."""
    by_alias: dict[str, dict] = {}
    order: list[str] = []
    for sel in selections:
        prev = by_alias.get(sel["alias"])
        if prev is None:
            by_alias[sel["alias"]] = dict(sel)
            order.append(sel["alias"])
        else:
            if prev["name"] != sel["name"] or prev["args"] != sel["args"]:
                # spec: OverlappingFieldsCanBeMerged — same response key
                # with different field/args is a document error, not a
                # silent last-wins
                raise CypherSyntaxError(
                    f"GraphQL: fields for key {sel['alias']!r} conflict "
                    "(different field or arguments)"
                )
            if sel["selections"] and prev["selections"]:
                prev["selections"] = prev["selections"] + sel["selections"]
            elif sel["selections"]:
                prev["selections"] = sel["selections"]
    return [by_alias[a] for a in order]


def _validate_spreads(selections: list[dict], fragments: dict[str, dict]) -> None:
    """Document-level validation: every ...spread must name a known fragment
    (real GraphQL validates before execution, so empty results still error)."""
    for sel in selections:
        if "spread" in sel:
            if sel["spread"] not in fragments:
                raise CypherSyntaxError(
                    f"GraphQL: unknown fragment {sel['spread']!r}"
                )
        elif sel.get("selections"):
            _validate_spreads(sel["selections"], fragments)


def _project(
    value: Any,
    selections: Optional[list[dict]],
    fragments: dict[str, dict],
    variables: dict,
) -> Any:
    """Apply a selection set to a result (GraphQL field projection)."""
    if selections is None or value is None:
        return value
    if isinstance(value, list):
        return [_project(v, selections, fragments, variables) for v in value]
    if not isinstance(value, dict):
        return value
    flat = _flatten_selections(
        selections, fragments, variables, value.get("__typename"))
    out = {}
    for sel in flat:
        if sel["name"] == "__typename":
            out[sel["alias"]] = value.get("__typename")
        else:
            out[sel["alias"]] = _project(
                value.get(sel["name"]), sel["selections"], fragments, variables)
    return out


class GraphQLExecutor:
    """(ref: pkg/graphql/handler.go + resolvers/)"""

    def __init__(self, db):
        self.db = db

    def execute(self, query: str, variables: Optional[dict] = None) -> dict:
        variables = dict(variables or {})
        try:
            doc = parse_document_cached(query)
            for k, v in doc.get("var_defaults", {}).items():
                variables.setdefault(k, v)
            fragments = doc.get("fragments", {})
            _validate_spreads(doc["selections"], fragments)
            for frag in fragments.values():
                _validate_spreads(frag["selections"], fragments)
            root_type = "Query" if doc["operation"] == "query" else "Mutation"
            root = _flatten_selections(
                doc["selections"], fragments, variables, root_type)
        except Exception as e:
            return {"errors": [{"message": f"parse error: {e}"}]}
        data = {}
        errors = []
        for sel in root:
            try:
                if sel["name"] == "__typename":
                    data[sel["alias"]] = root_type
                    continue
                args = _resolve_args(sel["args"], variables)
                value = self._resolve(doc["operation"], sel["name"], args)
                data[sel["alias"]] = _project(
                    value, sel["selections"], fragments, variables)
            except DeviceUnavailable:
                raise  # the edge's 503, never a field error with a 200
            except Exception as e:
                errors.append({"message": str(e), "path": [sel["alias"]]})
                data[sel["alias"]] = None
        out: dict[str, Any] = {"data": data}
        if errors:
            out["errors"] = errors
        return out

    # -- resolvers ----------------------------------------------------------
    def _resolve(self, op: str, field: str, args: dict) -> Any:
        db = self.db
        if op == "query":
            if field == "__schema":
                return _introspection_schema()
            if field == "__type":
                want = args.get("name")
                for t in _introspection_schema()["types"]:
                    if t["name"] == want:
                        return t
                return None
            if field == "node":
                return _node_obj(db.storage.get_node(args["id"]))
            if field == "nodes":
                label = args.get("label")
                limit = int(args.get("limit", 100))
                nodes = (
                    db.storage.get_nodes_by_label(label)
                    if label
                    else list(db.storage.all_nodes())
                )
                return [_node_obj(n) for n in sorted(nodes, key=lambda n: n.id)[:limit]]
            if field == "relationships":
                rtype = args.get("type")
                limit = int(args.get("limit", 100))
                edges = (
                    db.storage.get_edges_by_type(rtype)
                    if rtype
                    else list(db.storage.all_edges())
                )
                return [_edge_obj(e) for e in sorted(edges, key=lambda e: e.id)[:limit]]
            if field == "search":
                results = db.search.search(
                    args.get("query", ""), limit=int(args.get("limit", 10))
                )
                return [
                    {
                        "__typename": "SearchResult",
                        "id": r["id"],
                        "score": r["score"],
                        "content": r["content"],
                        "node": _node_obj(r["node"]),
                    }
                    for r in results
                ]
            if field == "similar":
                node = db.storage.get_node(args["id"])
                if node.embedding is None:
                    return []
                hits = db.search.vector_candidates(
                    node.embedding, k=int(args.get("limit", 10)) + 1
                )
                return [
                    {"__typename": "SimilarResult", "id": i, "score": s}
                    for i, s in hits if i != node.id
                ][: int(args.get("limit", 10))]
            if field == "cypher":
                result = db.executor.execute(
                    args.get("statement", ""), args.get("parameters") or {}
                )
                from nornicdb_tpu_torch.server.http import _jsonable

                return {
                    "__typename": "CypherResult",
                    "columns": result.columns,
                    "rows": [[_jsonable(v) for v in row] for row in result.rows],
                    "stats": result.stats.as_dict(),
                }
            if field == "neighbors":
                nodes = db.neighbors(args["id"], depth=int(args.get("depth", 1)))
                return [_node_obj(n) for n in nodes]
            if field == "stats":
                return {
                    "__typename": "Stats",
                    "nodes": db.storage.node_count(),
                    "edges": db.storage.edge_count(),
                    "pendingEmbeddings": len(db.storage.pending_embed_ids()),
                }
            raise NornicError(f"unknown query field {field}")
        if op == "mutation":
            if field == "createNode":
                node = Node(
                    labels=list(args.get("labels") or []),
                    properties=dict(args.get("properties") or {}),
                )
                return _node_obj(db.storage.create_node(node))
            if field == "updateNode":
                node = db.storage.get_node(args["id"])
                node.properties.update(args.get("properties") or {})
                return _node_obj(db.storage.update_node(node))
            if field == "deleteNode":
                db.storage.delete_node(args["id"])
                return True
            if field == "createRelationship":
                edge = Edge(
                    start_node=args["from"],
                    end_node=args["to"],
                    type=args.get("type", "RELATED_TO"),
                    properties=dict(args.get("properties") or {}),
                )
                return _edge_obj(db.storage.create_edge(edge))
            if field == "deleteRelationship":
                db.storage.delete_edge(args["id"])
                return True
            raise NornicError(f"unknown mutation field {field}")
        raise NornicError(f"unknown operation {op}")


# -- introspection (ref: pkg/graphql gqlgen emits the full spec schema;
# this is the minimal subset clients use for capability probing) ------------

def _t(name: str, kind: str = "SCALAR") -> dict:
    return {"__typename": "__Type", "kind": kind, "name": name, "ofType": None}


def _list(inner: dict) -> dict:
    """Spec wrapper type: kind LIST has name=null and ofType=element."""
    return {"__typename": "__Type", "kind": "LIST", "name": None,
            "ofType": inner}


def _f(name: str, type_: dict, args: Optional[list] = None) -> dict:
    return {
        "__typename": "__Field",
        "name": name,
        "args": args or [],
        "type": type_,
        "isDeprecated": False,
        "deprecationReason": None,
    }


def _arg(name: str, type_: dict) -> dict:
    return {"__typename": "__InputValue", "name": name, "type": type_,
            "defaultValue": None}


def _obj(name: str, fields: list[dict]) -> dict:
    return {
        "__typename": "__Type",
        "kind": "OBJECT",
        "name": name,
        "fields": fields,
        "ofType": None,
        "interfaces": [],
        "possibleTypes": None,
        "enumValues": None,
        "inputFields": None,
    }


def _introspection_schema() -> dict:
    STR, INT, BOOL, JSONT, ID = (
        _t("String"), _t("Int"), _t("Boolean"), _t("JSON"), _t("ID"))
    node = _obj("Node", [
        _f("id", ID), _f("labels", _list(_t("String", "SCALAR"))),
        _f("properties", JSONT), _f("decayScore", _t("Float")),
        _f("accessCount", INT),
    ])
    rel = _obj("Relationship", [
        _f("id", ID), _f("type", STR), _f("from", ID), _f("to", ID),
        _f("properties", JSONT), _f("confidence", _t("Float")),
        _f("autoGenerated", BOOL),
    ])
    search_result = _obj("SearchResult", [
        _f("id", ID), _f("score", _t("Float")), _f("content", STR),
        _f("node", _t("Node", "OBJECT")),
    ])
    cypher_result = _obj("CypherResult", [
        _f("columns", _list(_t("String", "SCALAR"))), _f("rows", JSONT),
        _f("stats", JSONT),
    ])
    stats = _obj("Stats", [
        _f("nodes", INT), _f("edges", INT), _f("pendingEmbeddings", INT),
    ])
    query = _obj("Query", [
        _f("node", _t("Node", "OBJECT"), [_arg("id", ID)]),
        _f("nodes", _list(_t("Node", "OBJECT")),
           [_arg("label", STR), _arg("limit", INT)]),
        _f("relationships", _list(_t("Relationship", "OBJECT")),
           [_arg("type", STR), _arg("limit", INT)]),
        _f("search", _list(_t("SearchResult", "OBJECT")),
           [_arg("query", STR), _arg("limit", INT)]),
        _f("similar", JSONT, [_arg("id", ID), _arg("limit", INT)]),
        _f("cypher", _t("CypherResult", "OBJECT"),
           [_arg("statement", STR), _arg("parameters", JSONT)]),
        _f("neighbors", _list(_t("Node", "OBJECT")),
           [_arg("id", ID), _arg("depth", INT)]),
        _f("stats", _t("Stats", "OBJECT")),
    ])
    mutation = _obj("Mutation", [
        _f("createNode", _t("Node", "OBJECT"),
           [_arg("labels", _list(_t("String", "SCALAR"))), _arg("properties", JSONT)]),
        _f("updateNode", _t("Node", "OBJECT"),
           [_arg("id", ID), _arg("properties", JSONT)]),
        _f("deleteNode", BOOL, [_arg("id", ID)]),
        _f("createRelationship", _t("Relationship", "OBJECT"),
           [_arg("from", ID), _arg("to", ID), _arg("type", STR),
            _arg("properties", JSONT)]),
        _f("deleteRelationship", BOOL, [_arg("id", ID)]),
    ])
    return {
        "__typename": "__Schema",
        "queryType": {"__typename": "__Type", "name": "Query"},
        "mutationType": {"__typename": "__Type", "name": "Mutation"},
        "subscriptionType": None,
        "types": [query, mutation, node, rel, search_result, cypher_result,
                  stats, STR, INT, BOOL, _t("Float"), ID, JSONT],
        "directives": [
            {"__typename": "__Directive", "name": "include",
             "locations": ["FIELD"], "args": [_arg("if", BOOL)]},
            {"__typename": "__Directive", "name": "skip",
             "locations": ["FIELD"], "args": [_arg("if", BOOL)]},
        ],
    }
