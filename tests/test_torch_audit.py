"""The port's audit log (``nornicdb_tpu_torch/audit.py``) on the CPU.

The JAX ``tests/test_subsystems.py::TestAudit`` cases, with only their
imports changed; then both packages' hash chains over the same events
with a fixed clock (every hash equal), and each package reading and
verifying the other's JSONL file.
"""

import json

import pytest

from nornicdb_tpu_torch.audit import AuditLog
from nornicdb_tpu_torch.storage import MemoryEngine


class TestAudit:
    def test_chain_and_verify(self, tmp_path):
        log = AuditLog(str(tmp_path / "audit.jsonl"))
        log.record("login_ok", "alice", {"ip": "10.0.0.1"})
        log.record("node_deleted", "bob")
        assert log.verify_chain()
        assert len(log.events("login_ok")) == 1
        # reload from disk preserves the chain
        log2 = AuditLog(str(tmp_path / "audit.jsonl"))
        assert log2.verify_chain()
        assert len(log2.events()) == 2

    def test_tamper_detected(self, tmp_path):
        log = AuditLog()
        log.record("a", "x")
        log.record("b", "y")
        log._events[0].detail["injected"] = True
        assert not log.verify_chain()

    def test_auth_hook_integration(self):
        from nornicdb_tpu_torch.auth import Authenticator, ROLE_VIEWER

        log = AuditLog()
        auth = Authenticator(MemoryEngine(), audit_hook=log.auth_hook())
        auth.create_user("u", "pw", ROLE_VIEWER)
        auth.authenticate("u", "pw")
        assert [e.event for e in log.events()] == ["user_created", "login_ok"]


_EVENTS = [
    ("login_ok", "alice", {"ip": "10.0.0.1"}),
    ("node_deleted", "bob", None),
    ("role_changed", "admin", {"user": "carol", "to": ["editor", "viewer"]}),
    ("query", "dave", {"cypher": "MATCH (n) RETURN n", "rows": 3,
                       "ms": 1.25, "ok": True, "nested": {"k": [1, None]}}),
    ("login_failed", "ünïcode", {"reason": "bad password"}),
]


class TestBothPackages:
    def _fill(self, cls, path, monkeypatch):
        clock = iter(1_700_000_000.0 + 0.125 * i for i in range(100))
        monkeypatch.setattr("time.time", lambda: next(clock))
        log = cls(str(path))
        for event, actor, detail in _EVENTS:
            log.record(event, actor, detail)
        monkeypatch.undo()
        return log

    def test_same_chain_and_each_reads_the_other(self, tmp_path,
                                                 monkeypatch):
        from nornicdb_tpu.audit import AuditLog as JaxAuditLog

        jlog = self._fill(JaxAuditLog, tmp_path / "jax.jsonl", monkeypatch)
        plog = self._fill(AuditLog, tmp_path / "port.jsonl", monkeypatch)
        assert [vars(e) for e in plog.events()] == \
            [vars(e) for e in jlog.events()]
        assert (tmp_path / "port.jsonl").read_bytes() == \
            (tmp_path / "jax.jsonl").read_bytes()
        assert AuditLog(str(tmp_path / "jax.jsonl")).verify_chain()
        assert JaxAuditLog(str(tmp_path / "port.jsonl")).verify_chain()
        # a line edited on disk breaks the chain for both readers
        lines = (tmp_path / "port.jsonl").read_text().splitlines()
        rec = json.loads(lines[2])
        rec["actor"] = "mallory"
        lines[2] = json.dumps(rec)
        (tmp_path / "bad.jsonl").write_text("\n".join(lines) + "\n")
        assert not AuditLog(str(tmp_path / "bad.jsonl")).verify_chain()
        assert not JaxAuditLog(str(tmp_path / "bad.jsonl")).verify_chain()

    @pytest.mark.parametrize("event_type,actor", [
        ("login_ok", None), (None, "bob"), ("query", "dave"), ("x", None)])
    def test_same_filters(self, tmp_path, monkeypatch, event_type, actor):
        from nornicdb_tpu.audit import AuditLog as JaxAuditLog

        jlog = self._fill(JaxAuditLog, tmp_path / "j.jsonl", monkeypatch)
        plog = self._fill(AuditLog, tmp_path / "p.jsonl", monkeypatch)
        assert [e.hash for e in plog.events(event_type, actor)] == \
            [e.hash for e in jlog.events(event_type, actor)]
