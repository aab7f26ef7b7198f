"""The port's configuration layer (``nornicdb_tpu_torch.config`` and the
search service's default-config layering) against the JAX package's.

The same YAML file and the same environment give the same ``AppConfig`` in
both packages, section by section; the reference's flat ``NORNICDB_*``
names, the feature flags and the import-URL gate agree. Then the search
layering: ``NORNICDB_SEARCH_<FIELD>`` and ``configure_defaults`` give the
same ``SearchConfig`` in both packages, and a port ``SearchService`` built
without a config takes it (before this layer the port ignored both).
"""

import dataclasses
import copy
import os

import pytest

from nornicdb_tpu import config as JC
from nornicdb_tpu.search import service as JS
from nornicdb_tpu_torch import config as PC

YAML = """
server:
  http_port: 8474
  auth_enabled: true
  base_path: /db
database:
  data_dir: /data/nornic
  async_writes: false
embedding:
  dimensions: 384
  provider: hash
memory:
  query_cache_ttl: 12.5
telemetry:
  trace_sample: 0.25
  slo_targets: "embed=100"
search:
  batching_enabled: true
  recall_target: 0.9
  n_probe: 7
serving:
  max_queue: 77
  deadline_ms: 1500
genserve:
  page_size: 32
  mode: dense
workers:
  http: 3
unknown_section:
  ignored: 1
"""

ENV = {
    "NORNICDB_HTTP_PORT": "9000",
    "NORNICDB_AUTH": "yes",
    "NORNICDB_ENCRYPTION_KEY": "k3y",
    "NORNICDB_STRICT_DURABILITY": "always",
    "NORNICDB_EMBEDDING_WORKERS": "4",
    "NORNICDB_QUERY_CACHE_TTL": "3.5",
    "NORNICDB_DEVICE_FALLBACK": "fail",
    "NORNICDB_EMBED_DEADLINE_MS": "250",
    "NORNICDB_STUDENT_MODEL": "/models/student",
    "NORNICDB_HTTP_WORKERS": "2",
    "NORNICDB_TRACE_SAMPLE": "0.5",
    # the section form wins over the flat alias when both are set
    "NORNICDB_SERVER_HTTP_PORT": "9100",
    "NORNICDB_SEARCH_WRITE_BEHIND": "true",
    "NORNICDB_GENSERVE_MAX_SEQS": "16",
    "NORNICDB_SERVING_MAX_ROWS": "32",
}


def _sections(cfg) -> dict:
    return {f.name: dataclasses.asdict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.fixture
def env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("NORNICDB_"):
            monkeypatch.delenv(k)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _assert_same(got: dict, want: dict) -> None:
    """The port's sections equal the JAX package's but for the one
    recorded difference: where JAX falls back to the CPU by default
    (``fallback="cpu"``), the port's device owner fails
    (``fallback="fail"``); a value set in a file or the environment is the
    same in both."""
    got, want = copy.deepcopy(got), copy.deepcopy(want)
    for sec in ("backend", "genserve"):
        j = want[sec].pop("fallback")
        assert got[sec].pop("fallback") == ("fail" if j == "cpu" else j)
    assert got == want


class TestAppConfig:
    def test_same_sections_and_fields(self):
        got = _sections(PC.AppConfig())
        want = _sections(JC.AppConfig())
        assert got["backend"]["fallback"] == "fail"
        assert want["backend"]["fallback"] == "cpu"
        _assert_same(got, want)
        assert PC.ENV_ALIASES == JC.ENV_ALIASES
        assert PC.CONFIG_FILENAMES == JC.CONFIG_FILENAMES

    def test_yaml_file(self, tmp_path):
        path = tmp_path / "nornicdb.yaml"
        path.write_text(YAML)
        got = _sections(PC.load_from_file(str(path)))
        _assert_same(got, _sections(JC.load_from_file(str(path))))
        assert got["server"]["http_port"] == 8474
        assert got["serving"]["max_queue"] == 77
        assert got["genserve"]["mode"] == "dense"
        assert isinstance(PC.load_from_file(str(path)).serving,
                          PC.ServingConfig)

    def test_env_and_aliases(self, env):
        got = _sections(PC.load_from_env())
        _assert_same(got, _sections(JC.load_from_env()))
        assert got["server"]["http_port"] == 9100
        assert got["server"]["auth_enabled"] is True
        assert got["database"]["wal_sync"] is True
        assert got["backend"]["fallback"] == "fail"
        assert got["serving"]["deadline_ms"] == 250.0
        assert got["genserve"]["max_seqs"] == 16

    def test_load_discovers_file_then_env(self, env, tmp_path):
        (tmp_path / ".nornicdb.yaml").write_text(YAML)
        deep = tmp_path / "a" / "b"
        deep.mkdir(parents=True)
        assert PC.find_config_file(str(deep)) == JC.find_config_file(
            str(deep)) == str(tmp_path / ".nornicdb.yaml")
        got = _sections(PC.load(str(deep)))
        _assert_same(got, _sections(JC.load(str(deep))))
        # the env overrides the file: 9100 beats 8474, 250 beats 1500
        assert got["server"]["http_port"] == 9100
        assert got["serving"]["deadline_ms"] == 250.0
        assert got["search"]["n_probe"] == 7

    @pytest.mark.parametrize("raw", ["1", "true", "YES", "always", "sync",
                                     "0", "false", "off", "42", "2.5", "x"])
    def test_coerce_env(self, raw):
        for current in (True, 3, 1.5, "s"):
            try:
                want = JC._coerce_env(current, raw)
            except ValueError:
                with pytest.raises(ValueError):
                    PC._coerce_env(current, raw)
                continue
            assert PC._coerce_env(current, raw) == want

    def test_serving_sections_keep_from_env(self):
        environ = {"NORNICDB_SERVING_MAX_QUEUE": "9",
                   "NORNICDB_GENSERVE_ENABLED": "false"}
        assert PC.ServingConfig.from_env(environ).max_queue == 9
        assert PC.GenServeConfig.from_env(environ).enabled is False


class TestFeatureFlags:
    def test_defaults_and_env(self, env):
        env.setenv("NORNICDB_MMR_ENABLED", "true")
        env.setenv("NORNICDB_FLAG_KALMAN", "0")
        env.setenv("NORNICDB_AUTO_TLP_LLM_QC_ENABLED", "yes")
        p, j = PC.FeatureFlags(), JC.FeatureFlags()
        assert p.all() == j.all()
        assert p.is_enabled("mmr") and not p.is_kalman_enabled()
        assert p.is_auto_tlp_enabled() == j.is_auto_tlp_enabled()

    def test_with_enabled_restores(self):
        f = PC.FeatureFlags()
        with f.with_enabled("mmr", True):
            assert f.is_enabled("mmr")
        assert f.is_enabled("mmr") is False
        f.set("new_flag", True)
        assert f.all()["new_flag"] is True


class TestImportUrl:
    def test_disabled_by_default(self, env):
        env.delenv("NORNICDB_APOC_IMPORT_ENABLED", raising=False)
        for mod in (PC, JC):
            with pytest.raises(PermissionError, match="disabled"):
                mod.resolve_import_url("file:///etc/hosts")

    def test_schemes_and_confinement(self, env, tmp_path):
        env.setenv("NORNICDB_APOC_IMPORT_ENABLED", "true")
        env.setenv("NORNICDB_IMPORT_DIR", str(tmp_path))
        inside = tmp_path / "in.csv"
        inside.write_text("a\n")
        for mod in (PC, JC):
            assert mod.resolve_import_url(f"file://{inside}") == str(inside)
            with pytest.raises(PermissionError, match="zero-egress"):
                mod.resolve_import_url("http://example.invalid/x.csv")
            with pytest.raises(PermissionError, match="escapes"):
                mod.resolve_import_url("/etc/hosts")


@pytest.fixture
def search_defaults(monkeypatch):
    """No NORNICDB_SEARCH_* in the environment and no configure_defaults
    overrides in either package, before and after."""
    from nornicdb_tpu_torch.search import service as PS

    for k in list(os.environ):
        if k.startswith("NORNICDB_SEARCH_"):
            monkeypatch.delenv(k)
    JS._CONFIG_DEFAULTS.clear()
    PS._CONFIG_DEFAULTS.clear()
    yield monkeypatch, PS
    JS._CONFIG_DEFAULTS.clear()
    PS._CONFIG_DEFAULTS.clear()


class TestSearchConfigLayering:
    """Fault: the port's SearchService took a bare SearchConfig(), so with
    any NORNICDB_SEARCH_* set or configure_defaults called the packages
    searched differently."""

    def test_same_fields_and_defaults(self, search_defaults):
        _, PS = search_defaults
        assert dataclasses.asdict(PS.SearchConfig()) == dataclasses.asdict(
            JS.SearchConfig())

    @pytest.mark.parametrize("name,raw", [
        ("BATCHING_ENABLED", "true"), ("WRITE_BEHIND", "yes"),
        ("RECALL_TARGET", "0.9"), ("N_PROBE", "5"), ("EXACT", "1"),
        ("CANDIDATES_MULTIPLIER", "6"), ("BACKEND", "hnsw"),
        ("TUNE_MIN_ROWS", "128"), ("BATCH_DEADLINE_MS", "40"),
    ])
    def test_env_gives_the_same_config(self, search_defaults, name, raw):
        monkeypatch, PS = search_defaults
        monkeypatch.setenv(f"NORNICDB_SEARCH_{name}", raw)
        got = dataclasses.asdict(PS.default_search_config())
        assert got == dataclasses.asdict(JS.default_search_config())
        assert got != dataclasses.asdict(PS.SearchConfig())

    def test_configure_defaults_wins_over_env(self, search_defaults):
        monkeypatch, PS = search_defaults
        monkeypatch.setenv("NORNICDB_SEARCH_RECALL_TARGET", "0.8")
        kw = {"recall_target": 0.97, "batching_enabled": True,
              "write_behind": True, "mmr_lambda": 0.5}
        PS.configure_defaults(**kw)
        JS.configure_defaults(**kw)
        got = PS.default_search_config()
        assert dataclasses.asdict(got) == dataclasses.asdict(
            JS.default_search_config())
        assert got.recall_target == 0.97
        with pytest.raises(ValueError, match="unknown"):
            PS.configure_defaults(no_such_knob=1)

    def test_app_config_section_installs(self, search_defaults):
        """``configure_defaults(**vars(AppConfig().search))``, as a server
        installs the operator's section, is accepted field by field."""
        _, PS = search_defaults
        PS.configure_defaults(**vars(PC.AppConfig().search))
        JS.configure_defaults(**vars(JC.AppConfig().search))
        assert dataclasses.asdict(PS.default_search_config()) == \
            dataclasses.asdict(JS.default_search_config())

    @pytest.mark.parametrize("name,value,raw", [
        ("local_k", 40, "40"), ("sharded_min_rows", 1000, "1000"),
        ("int8_residency", True, "true"), ("rescore_factor", 8, "8"),
        ("backend", "sharded", "sharded"),
    ])
    def test_sharded_options_are_refused(self, search_defaults, name,
                                         value, raw):
        """The sharded corpus is not ported (ROADMAP A7): a non-default
        value of an option only it reads is refused, through
        configure_defaults, the environment or an explicit config, and
        never accepted to do nothing."""
        monkeypatch, PS = search_defaults
        with pytest.raises(ValueError, match="ROADMAP A7"):
            PS.configure_defaults(**{name: value})
        assert PS._CONFIG_DEFAULTS == {}
        with pytest.raises(ValueError, match="ROADMAP A7"):
            PS.SearchService(config=PS.SearchConfig(**{name: value}),
                             device="cpu")
        monkeypatch.setenv(f"NORNICDB_SEARCH_{name.upper()}", raw)
        assert getattr(PS.default_search_config(), name) == value
        with pytest.raises(ValueError, match="ROADMAP A7"):
            PS.SearchService(device="cpu")

    def test_service_without_config_takes_the_layered_one(
            self, search_defaults):
        monkeypatch, PS = search_defaults
        monkeypatch.setenv("NORNICDB_SEARCH_MMR_ENABLED", "true")
        PS.configure_defaults(rrf_k=30.0)
        svc = PS.SearchService(device="cpu")
        assert svc.config.mmr_enabled is True and svc.config.rrf_k == 30.0
        explicit = PS.SearchService(config=PS.SearchConfig(), device="cpu")
        assert explicit.config.mmr_enabled is False
