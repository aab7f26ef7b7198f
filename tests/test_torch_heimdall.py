"""The port's Heimdall (``nornicdb_tpu_torch.heimdall``): its manager, prompt
context, registries, event dispatcher and plugins against the JAX
package's.

The cases of ``tests/test_heimdall_depth.py`` that need neither Cypher nor
the HTTP server run in both packages (database events come from the DB's
own API in place of a Cypher CREATE); the ``query`` action, which runs
Cypher, fails through the action's error path until the port has an
executor. Then both packages are held equal on the same inputs:
``try_parse_action`` over a table of strings, the final prompt, the
template generator's answers over the same DB, chat and streamed chat
through a scripted generator.
"""

import time

import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu import heimdall as JH
from nornicdb_tpu.heimdall import plugins as JP
from nornicdb_tpu_torch import heimdall as PH
from nornicdb_tpu_torch.heimdall import plugins as PP

PKGS = {
    "jax": (JH, JP, lambda: nornicdb_tpu.open_db("")),
    "torch": (PH, PP, lambda: nornicdb_tpu_torch.open_db("", device="cpu")),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def db(pkg):
    d = pkg[2]()
    yield d
    d.close()


def _echo(H, reply: str = "ok"):
    class EchoGenerator(H.Generator):
        def __init__(self):
            self.reply = reply
            self.last_prompt = ""

        def generate(self, prompt, max_tokens=128):
            self.last_prompt = prompt
            return self.reply

    return EchoGenerator()


# ---- cases of tests/test_heimdall_depth.py, in both packages
class TestPromptContext:
    def test_full_prompt_sections(self, pkg):
        H = pkg[0]
        ctx = H.PromptContext("hello", action_prompt="- status: health")
        ctx.additional_instructions = "Graph has 5 nodes."
        ctx.examples.append(H.PromptExample("hi", '{"action": "hello"}'))
        p = ctx.build_final_prompt()
        assert "AVAILABLE ACTIONS" in p and "- status: health" in p
        assert "CYPHER QUERY REFERENCE" in p
        assert "ADDITIONAL CONTEXT" in p and "5 nodes" in p
        assert 'User: "hi"' in p

    def test_minimal_fallback_when_over_budget(self, pkg):
        H = pkg[0]
        ctx = H.PromptContext("q", action_prompt="- a: b",
                              budget=H.TokenBudget(max_system=50))
        ctx.additional_instructions = "x" * 4000
        p = ctx.build_final_prompt()
        assert "ACTIONS" in p
        assert "ADDITIONAL CONTEXT" not in p

    def test_token_estimate_and_budget_validation(self, pkg):
        H = pkg[0]
        assert H.estimate_tokens("a" * 400) == 100
        ctx = H.PromptContext("u" * 400, budget=H.TokenBudget(max_user=10))
        err = ctx.validate_token_budget()
        assert err is not None and "user message" in err

    def test_cancellation(self, pkg):
        ctx = pkg[0].PromptContext("q")
        assert not ctx.cancelled
        ctx.cancel("policy", "guard-plugin")
        assert ctx.cancelled and ctx.cancel_reason == "policy"
        assert ctx.cancelled_by == "guard-plugin"

    def test_notification_queue_drains_once(self, pkg):
        ctx = pkg[0].PromptContext("q")
        ctx.notify_info("t", "m")
        ctx.notify_warning("t2", "m2")
        notes = ctx.drain_notifications()
        assert [n.type for n in notes] == ["info", "warning"]
        assert ctx.drain_notifications() == []

    def test_budget_from_env(self, pkg, monkeypatch):
        monkeypatch.setenv("NORNICDB_HEIMDALL_MAX_SYSTEM_TOKENS", "123")
        monkeypatch.setenv("NORNICDB_HEIMDALL_MAX_USER_TOKENS", "bad")
        b = pkg[0].TokenBudget.from_env()
        assert (b.max_system, b.max_user) == (123, 2000)


class TestModelRegistry:
    def test_register_default_and_select(self, pkg):
        H = pkg[0]
        reg = H.ModelRegistry()
        reg.register(H.ModelInfo(name="m1", type=H.MODEL_REASONING,
                                 backend="b1"))
        reg.register(H.ModelInfo(name="m2", type=H.MODEL_REASONING,
                                 backend="b2"), default=True)
        assert reg.default_for(H.MODEL_REASONING).name == "m2"
        assert reg.acquire("m1") == "b1"
        assert reg.get("m1").last_used > 0

    def test_lazy_loader_and_unload(self, pkg):
        H = pkg[0]
        loads = []
        reg = H.ModelRegistry()
        reg.register(H.ModelInfo(
            name="lazy", type=H.MODEL_CLASSIFICATION,
            loader=lambda: loads.append(1) or "backend"))
        assert reg.get("lazy").loaded is False
        assert reg.acquire("lazy") == "backend"
        assert reg.get("lazy").loaded is True and loads == [1]
        assert reg.unload("lazy") is True
        assert reg.get("lazy").loaded is False

    def test_unknown_type_rejected(self, pkg):
        H = pkg[0]
        with pytest.raises(ValueError):
            H.ModelRegistry().register(H.ModelInfo(name="x", type="nope"))


class TestMetricsRegistry:
    def test_counters_gauges_prometheus(self, pkg):
        m = pkg[0].MetricsRegistry(prefix="heimdall")
        m.inc("chat_requests")
        m.inc("chat_requests", 2)
        m.set_gauge("queue_depth", 7)
        assert m.get("chat_requests") == 3
        text = m.render_prometheus()
        assert "# TYPE heimdall_chat_requests counter" in text
        assert "heimdall_queue_depth 7" in text


class TestEventDispatcher:
    def test_async_delivery_and_stop(self, pkg):
        H = pkg[0]
        d = H.EventDispatcher()
        seen = []
        d.subscribe(seen.append)
        d.start()
        assert d.emit_node_event("created", "n1", ["A"]) is True
        assert d.emit_relationship_event("created", "e1", "KNOWS",
                                         "n1", "n2") is True
        deadline = time.time() + 5
        while len(seen) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert [e.type for e in seen] == ["created", "created"]
        assert seen[1].relationship_type == "KNOWS"
        d.stop()
        assert d.emit(H.DatabaseEvent(type="x")) is False

    def test_broken_subscriber_isolated(self, pkg):
        d = pkg[0].EventDispatcher()
        seen = []
        d.subscribe(lambda e: 1 / 0)
        d.subscribe(seen.append)
        d.start()
        d.emit_query_event("slow_query", "MATCH (n) RETURN n", 2.5)
        deadline = time.time() + 5
        while not seen and time.time() < deadline:
            time.sleep(0.01)
        assert seen[0].query == "MATCH (n) RETURN n"
        d.stop()


class TestChatMachinery:
    def test_chat_prompt_includes_actions_and_examples(self, pkg, db):
        H = pkg[0]
        gen = _echo(H, "plain answer")
        out = H.HeimdallManager(gen, db=db).chat(
            [{"role": "user", "content": "what is up"}])
        assert "AVAILABLE ACTIONS" in gen.last_prompt
        assert "- query:" in gen.last_prompt
        assert "usage" in out and out["usage"]["total_tokens"] > 0

    def test_status_action_reports_counts(self, pkg, db):
        H = pkg[0]
        a, b = db.store("a"), db.store("b")
        db.link(a.id, b.id)
        out = H.HeimdallManager(
            _echo(H, 'ok {"action": "status", "params": {}}'), db=db).chat(
            [{"role": "user", "content": "health?"}])
        assert out["action_result"] == {"status": "ok", "nodes": 2,
                                        "edges": 1}

    def test_query_action_needs_the_executor(self, pkg, db):
        """The action runs through the DB's Cypher executor (JAX
        ``heimdall/manager.py:373-395``): reads answer, a write is refused
        before it reaches the executor, a missing statement is an error."""
        H = pkg[0]
        db.cypher("CREATE (:T {v: 1}), (:T {v: 2})")
        gen = _echo(H, '{"action": "query", "params": {"cypher": '
                       '"MATCH (n:T) RETURN count(n)"}}')
        mgr = H.HeimdallManager(gen, db=db)
        assert "- query:" in mgr.action_prompt()
        out = mgr.chat([{"role": "user", "content": "count"}])
        assert out["action_result"] == {
            "columns": ["count(n)"], "rows": [[2]], "row_count": 1}
        wipe = _echo(H, '{"action": "query", "params": {"cypher": '
                        '"MATCH (n) DETACH DELETE n"}}')
        out = H.HeimdallManager(wipe, db=db).chat(
            [{"role": "user", "content": "wipe it"}])
        assert "read-only" in out["action_result"]["error"]
        assert db.storage.node_count() == 2  # nothing deleted
        missing = mgr._dispatch_action({"action": "query", "params": {}})
        assert missing == {"error": "params.cypher required"}

    def test_alt_model_still_passes_plugin_hooks(self, pkg, db):
        H, P, _ = pkg
        alt = _echo(H, "alt")
        mgr = H.HeimdallManager(_echo(H, "default"), db=db)
        host = P.PluginHost(mgr, db=db)

        class Stamp(P.HeimdallPlugin):
            name = "stamp"

            def pre_prompt(self, prompt: str) -> str:
                return "STAMPED\n" + prompt

        host.register(Stamp())
        mgr.models.register(H.ModelInfo(name="alt", type=H.MODEL_REASONING,
                                        backend=alt, loaded=True))
        mgr.chat([{"role": "user", "content": "x"}], model="alt")
        assert alt.last_prompt.startswith("STAMPED")

    def test_backendless_model_errors_cleanly(self, pkg, db):
        H = pkg[0]
        mgr = H.HeimdallManager(_echo(H), db=db)
        mgr.models.register(H.ModelInfo(name="meta", type=H.MODEL_REASONING))
        out = mgr.chat([{"role": "user", "content": "x"}], model="meta")
        assert out["error"]["type"] == "invalid_request_error"

    def test_stream_error_chunk_for_unknown_model(self, pkg, db):
        H = pkg[0]
        mgr = H.HeimdallManager(_echo(H), db=db)
        chunks = list(mgr.chat_stream([{"role": "user", "content": "x"}],
                                      model="ghost"))
        assert len(chunks) == 1 and "error" in chunks[0]

    def test_model_selection_and_unknown_model(self, pkg, db):
        H = pkg[0]
        mgr = H.HeimdallManager(_echo(H, "default"), db=db)
        mgr.models.register(H.ModelInfo(
            name="alt", type=H.MODEL_REASONING, backend=_echo(H, "alt!"),
            loaded=True))
        out = mgr.chat([{"role": "user", "content": "x"}], model="alt")
        assert out["choices"][0]["message"]["content"] == "alt!"
        assert out["model"] == "alt"
        err = mgr.chat([{"role": "user", "content": "x"}], model="ghost")
        assert err["error"]["type"] == "invalid_request_error"

    def test_plugin_context_hook_cancels(self, pkg, db):
        H, P, _ = pkg
        mgr = H.HeimdallManager(_echo(H), db=db)
        host = P.PluginHost(mgr, db=db)

        class Guard(P.HeimdallPlugin):
            name = "guard"

            def pre_prompt_context(self, ctx) -> None:
                if "forbidden" in ctx.user_message:
                    ctx.cancel("blocked by policy")

        host.register(Guard())
        out = mgr.chat([{"role": "user", "content": "forbidden topic"}])
        assert out["choices"][0]["finish_reason"] == "cancelled"
        assert out["cancelled_by"] == "guard"
        ok = mgr.chat([{"role": "user", "content": "fine"}])
        assert ok["choices"][0]["finish_reason"] == "stop"

    def test_plugin_context_hook_adds_examples(self, pkg, db):
        H, P, _ = pkg
        gen = _echo(H)
        mgr = H.HeimdallManager(gen, db=db)
        host = P.PluginHost(mgr, db=db)

        class Domain(P.HeimdallPlugin):
            name = "domain"

            def pre_prompt_context(self, ctx) -> None:
                ctx.examples.append(
                    H.PromptExample("special", '{"action": "special"}'))

        host.register(Domain())
        mgr.chat([{"role": "user", "content": "hi"}])
        assert 'User: "special"' in gen.last_prompt

    def test_stream_flushes_notifications_first(self, pkg, db):
        H = pkg[0]
        mgr = H.HeimdallManager(_echo(H, "streamed words here"), db=db)
        mgr.context_hooks.append(
            lambda ctx: ctx.notify_progress("working", "thinking"))
        chunks = list(mgr.chat_stream([{"role": "user", "content": "x"}]))
        assert "notification" in chunks[0]
        assert chunks[0]["notification"]["type"] == "progress"
        content = "".join(
            c["choices"][0]["delta"].get("content", "")
            for c in chunks[1:] if c.get("choices"))
        assert content == "streamed words here"

    def test_async_db_events_reach_plugins(self, pkg, db):
        H, P, _ = pkg
        mgr = H.HeimdallManager(H.TemplateGenerator(db), db=db)
        host = P.PluginHost(mgr, db=db)
        seen = []

        class Watch(P.HeimdallPlugin):
            name = "watch"

            def on_db_event(self, kind, event) -> None:
                seen.append((kind, event))

        host.register(Watch())
        a = db.store("x1", labels=["Evt"])
        b = db.store("x2", labels=["Evt"])
        db.link(a.id, b.id, "R")
        deadline = time.time() + 5
        while len(seen) < 3 and time.time() < deadline:
            time.sleep(0.01)
        kinds = [k for k, _ in seen]
        assert any("creat" in k for k in kinds)
        rel_events = [e for _, e in seen if e.relationship_type == "R"]
        assert rel_events and rel_events[0].source_node_id == a.id


class TestStreamingPluginGuards:
    def test_pre_prompt_applies_to_native_stream(self, pkg, db):
        H, P, _ = pkg
        seen = {}

        class EchoStream(H.Generator):
            def generate(self, prompt, max_tokens=128):
                return "full"

            def generate_stream(self, prompt, max_tokens=128):
                seen["prompt"] = prompt
                yield "chunk"

        class Redactor:
            name = "redactor"

            def pre_prompt(self, prompt):
                return prompt.replace("SECRET", "[redacted]")

        mgr = H.HeimdallManager(EchoStream(), db=db)
        host = P.PluginHost(mgr)
        host._plugins["redactor"] = Redactor()
        list(mgr.chat_stream([{"role": "user", "content": "tell SECRET"}]))
        assert "SECRET" not in seen["prompt"]
        assert "[redacted]" in seen["prompt"]

    def test_stream_error_event_on_backend_failure(self, pkg, db):
        H = pkg[0]

        class Exploder(H.Generator):
            def generate(self, prompt, max_tokens=128):
                return "x"

            def generate_stream(self, prompt, max_tokens=128):
                yield "partial"
                raise RuntimeError("decode blew up")

        mgr = H.HeimdallManager(Exploder(), db=db)
        chunks = list(mgr.chat_stream([{"role": "user", "content": "x"}]))
        assert any("error" in c for c in chunks)
        assert chunks[-1]["choices"][0]["finish_reason"] == "error"
        assert mgr.metrics.errors == 1


# ---- the plugin cases of tests/test_integrations.py, in both packages
class TestPlugins:
    def test_watcher_lifecycle_and_db_events(self, pkg, db):
        H, P, _ = pkg
        host = P.PluginHost(db.heimdall, db=db)
        assert host.register(P.WatcherPlugin()).name == "watcher"
        db.store("watched", labels=["W"])
        plugin = host._plugins["watcher"]
        deadline = time.time() + 5
        while not plugin.events.get("node_created") and \
                time.time() < deadline:
            time.sleep(0.01)
        assert plugin.events.get("node_created") == 1
        result = host.run_action({"action": "watcher.status", "params": {}})
        assert result["events"]["node_created"] == 1
        assert host.run_action({"action": "status", "params": {}})[
            "nodes"] == 1
        assert host.plugins()[0].healthy
        host.unregister("watcher")
        assert "watcher.status" not in db.heimdall._actions

    def test_pre_execute_veto(self, pkg):
        H, P, _ = pkg
        host = P.PluginHost(H.HeimdallManager(H.TemplateGenerator(None)))

        class VetoPlugin(P.HeimdallPlugin):
            name = "veto"

            def pre_execute(self, action):
                return None if action.get("action") == "danger" else action

        host.register(VetoPlugin())
        assert host.run_action({"action": "danger"}) == {"vetoed_by": "veto"}

    def test_load_directory(self, pkg, tmp_path):
        H, P, _ = pkg
        (tmp_path / "myplug.py").write_text(
            f"from {P.__name__} import HeimdallPlugin\n"
            "class P(HeimdallPlugin):\n"
            "    name = 'dirplug'\n"
            "    def actions(self):\n"
            "        return {'ping': lambda p: {'pong': True}}\n"
            "PLUGIN = P()\n")
        (tmp_path / "broken.py").write_text("raise RuntimeError('nope')\n")
        host = P.PluginHost(H.HeimdallManager(H.TemplateGenerator(None)))
        assert [i.name for i in host.load_directory(str(tmp_path))] == [
            "dirplug"]
        assert host.run_action({"action": "ping"}) == {"pong": True}


# ---- both packages on the same inputs
ACTION_TEXTS = [
    '{"action": "status", "params": {}}',
    'preamble {"action": "status", "params": {}} trailer',
    '{ " action " : " query " , " params " : { " cypher " : '
    '" match ( n ) return n " } }',
    '{"params": {"x": {"y": 1}}, "action": "hello"}',
    '{"a": 1} {"action": "hello"}',
    '{"action": "broken"',
    '"action" without braces',
    "no action at all",
    '{"nested": {"action": "inner"}}',
    '{"action": ["list"]} tail }',
    '{}{"action": "x", "params": {"k": "v { }"}}',
    "",
]


@pytest.mark.parametrize("text", ACTION_TEXTS)
def test_try_parse_action_same(text):
    assert PH.HeimdallManager.try_parse_action(text) == \
        JH.HeimdallManager.try_parse_action(text)


TEMPLATE_PROMPTS = [
    "how many nodes are there?",
    "How many relationships exist?",
    "search for ravens",
    "find norse mythology",
    "recall nothingmatcheshere",
    "what is the status",
    "is it healthy?",
    "hello",
]


def _filled(open_fn):
    from nornicdb_tpu.embed import HashEmbedder as JHash
    from nornicdb_tpu_torch.embed import HashEmbedder as PHash

    db = open_fn()
    jax = isinstance(db, nornicdb_tpu.DB)
    db.set_embedder((JHash if jax else PHash)(32))
    ids = [db.store(t, node_id=f"m{i}").id for i, t in enumerate((
        "norse mythology and ravens", "cooking pasta recipes",
        "ravens are clever birds", "graph databases store edges"))]
    db.link(ids[0], ids[2], "ABOUT")
    db.process_pending_embeddings()
    return db


@pytest.mark.parametrize("prompt", TEMPLATE_PROMPTS)
def test_template_answers_same(prompt):
    dbs = [_filled(PKGS[k][2]) for k in ("jax", "torch")]
    try:
        want, got = (PKG[0].TemplateGenerator(d).generate(prompt)
                     for PKG, d in zip((PKGS["jax"], PKGS["torch"]), dbs))
        assert got == want
    finally:
        for d in dbs:
            d.close()


def test_chat_and_stream_same():
    """One chat and one streamed chat through a scripted generator, with a
    status action and a notification hook, in both packages: equal but
    for the request id and time."""
    out = {}
    for name in ("jax", "torch"):
        H, _, open_fn = PKGS[name]
        db = _filled(open_fn)
        try:
            gen = _echo(H, 'sure {"action": "status", "params": {}}')
            mgr = H.HeimdallManager(gen, db=db)
            mgr.context_hooks.append(lambda ctx: ctx.notify_info("t", "m"))
            msgs = [{"role": "system", "content": "be brief"},
                    {"role": "user", "content": "how is the graph?"}]
            chat = mgr.chat(msgs, max_tokens=32)
            for k in ("id", "created"):
                chat.pop(k)
            stream = list(mgr.chat_stream(msgs))
            out[name] = (chat, stream, gen.last_prompt, mgr.action_prompt(),
                         vars(mgr.metrics)["generations"],
                         mgr.metrics_registry.snapshot())
        finally:
            db.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["action_result"]["nodes"] == 4
