"""OpenAPI surface tests (ref: docs/api-reference/openapi.yaml +
cmd/swagger-ui).

The spec is generated from code, so the contract these tests pin down is:
(1) the three docs endpoints serve, (2) EVERY path documented in the spec
is actually routable on a live server — a 404 on a documented path means
the spec drifted from the handlers, which is the exact failure mode that
motivated generating it from code — and (3) the endpoints the reference's
spec documents are covered here too.

The port's copy of ``tests/test_openapi.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
``/admin/tpu/status`` reports ``"framework": "torch"``.
"""

import json
import urllib.error
import urllib.request

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.server.http import HttpServer
from nornicdb_tpu_torch.server.openapi import build_spec, to_yaml


@pytest.fixture(scope="module")
def server():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    s = HttpServer(db, port=0)
    s.start()
    yield s
    s.stop()
    db.close()


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        resp = urllib.request.urlopen(req, timeout=30)
        return resp.status
    except urllib.error.HTTPError as e:
        return e.code


class TestDocsEndpoints:
    def test_openapi_json_serves_and_parses(self, server):
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/openapi.json").read()
        spec = json.loads(raw)
        assert spec["openapi"].startswith("3.")
        assert len(spec["paths"]) >= 30

    def test_openapi_yaml_serves_and_parses(self, server):
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/openapi.yaml").read().decode()
        yaml = pytest.importorskip("yaml")
        spec = yaml.safe_load(raw)
        assert spec["paths"] == build_spec()["paths"]

    def test_docs_explorer_serves(self, server):
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/docs").read().decode()
        assert "openapi.json" in raw and "<html" in raw.lower()

    def test_yaml_roundtrip_is_lossless(self):
        yaml = pytest.importorskip("yaml")
        spec = build_spec()
        assert yaml.safe_load(to_yaml(spec)) == spec


class TestSpecMatchesHandlers:
    """Every documented path must be routable — never 404/405."""

    _SUBST = {"{database}": "neo4j", "{username}": "spec-probe-user"}

    def test_every_documented_path_is_routable(self, server):
        spec = build_spec()
        misses = []
        for path, methods in spec["paths"].items():
            concrete = path
            for k, v in self._SUBST.items():
                concrete = concrete.replace(k, v)
            for method, op in methods.items():
                body = {} if "requestBody" in op else None
                status = _call(server.port, method.upper(), concrete, body)
                # anything but not-found/method-not-allowed proves routing;
                # 400/401/404-for-entity are handler-level responses.
                if status in (404, 405) and path not in (
                    "/auth/users/{username}",  # probe user doesn't exist
                    "/admin/traces/{trace_id}",  # probe trace doesn't exist
                ):
                    misses.append(f"{method.upper()} {path} -> {status}")
        assert not misses, misses

    def test_reference_documented_endpoints_covered(self):
        """The endpoints the reference's openapi.yaml documents (and that
        this framework implements) appear in our spec."""
        ours = set(build_spec()["paths"])
        for p in ["/health", "/status", "/metrics", "/auth/token",
                  "/auth/logout", "/auth/me", "/auth/api-token",
                  "/auth/users", "/auth/users/{username}",
                  "/db/{database}/tx/commit", "/nornicdb/search",
                  "/nornicdb/similar", "/admin/stats", "/admin/backup",
                  "/gdpr/export", "/gdpr/delete", "/graphql"]:
            assert p in ours, f"reference endpoint {p} missing from spec"

    def test_docs_endpoints_respect_headless_flag(self):
        """serve_ui=False (the reference's -tags noui equivalent) must
        expose no docs/HTML surface — the spec enumerates every endpoint."""
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        s = HttpServer(db, port=0, serve_ui=False)
        s.start()
        try:
            for path in ("/docs", "/openapi.json", "/openapi.yaml"):
                assert _call(s.port, "GET", path) == 404, path
        finally:
            s.stop()
            db.close()

    def test_security_schemes_declared(self):
        spec = build_spec()
        schemes = spec["components"]["securitySchemes"]
        assert {"bearerAuth", "basicAuth", "cookieAuth"} <= set(schemes)
        # auth'd ops reference the schemes
        tx = spec["paths"]["/db/{database}/tx/commit"]["post"]
        assert any("bearerAuth" in s for s in tx["security"])


class TestAdminConfigEndpoints:
    """ref: server_admin.go handleAdminConfig + server_gpu.go status."""

    def test_get_config_and_flags(self, server):
        status = _call(server.port, "GET", "/admin/config")
        assert status == 200
        raw = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/admin/config").read())
        assert "config" in raw and "feature_flags" in raw
        assert isinstance(raw["feature_flags"], dict)

    def test_post_toggles_flag_and_rejects_unknown(self, server):
        import urllib.error as _err

        url = f"http://127.0.0.1:{server.port}/admin/config"
        flags = json.loads(urllib.request.urlopen(url).read())["feature_flags"]
        name = sorted(flags)[0]

        def post(payload):
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req).read())

        try:
            out = post({"feature_flags": {name: not flags[name]}})
            assert out["feature_flags"][name] == (not flags[name])
        finally:
            # the flags registry is process-global — always restore, or a
            # failure here poisons every later test in the run
            post({"feature_flags": {name: flags[name]}})
        # unknown flag -> 400 with the valid set
        with pytest.raises(_err.HTTPError) as e:
            post({"feature_flags": {"bogus_flag": True}})
        assert e.value.code == 400
        # non-boolean value -> 400 (bool("false") is True; coercion would
        # silently enable a flag the client asked to disable)
        with pytest.raises(_err.HTTPError) as e:
            post({"feature_flags": {name: "false"}})
        assert e.value.code == 400
        after = json.loads(urllib.request.urlopen(url).read())
        assert after["feature_flags"][name] == flags[name]

    def test_config_redacts_secret_material(self):
        """encryption_passphrase etc. must never appear in responses —
        they flow through proxies and logs. Uses its own server with a
        passphrase actually SET, so the assertion is never vacuous."""
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        db.config.encryption_passphrase = "hunter2-redact-probe"
        s = HttpServer(db, port=0)
        s.start()
        try:
            raw = urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/admin/config").read().decode()
            assert "hunter2-redact-probe" not in raw
            cfg = json.loads(raw)["config"]
            assert cfg["encryption_passphrase"] == "<redacted>"
            # the inert Config.feature_flags seed must not shadow the live
            # top-level registry
            assert "feature_flags" not in cfg
        finally:
            s.stop()
            db.close()

    def test_post_falsy_non_dict_feature_flags_rejected(self, server):
        """[] / false / 0 must 400 like any other non-object, not be
        silently coerced to 'no updates'."""
        import urllib.error as _err

        url = f"http://127.0.0.1:{server.port}/admin/config"
        for bad in ([], False, 0, "x"):
            req = urllib.request.Request(
                url, data=json.dumps({"feature_flags": bad}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with pytest.raises(_err.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 400, bad

    def test_tpu_status_never_blocks(self, server):
        import time as _time

        t0 = _time.time()
        raw = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/admin/tpu/status",
            timeout=10).read())
        assert _time.time() - t0 < 5, "status endpoint must not block"
        assert raw["framework"] == "torch"
        assert "backend_initialized" in raw
