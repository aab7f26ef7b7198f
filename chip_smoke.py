#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nornicdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Builds the port's CUDA kernels from ``nornicdb_tpu_torch/ops/csrc`` (one
``nvcc`` per source, in parallel), then at the headline serving size
(1,000,000 x 1024 vectors, bge-m3's width; top-100):

1. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (Q = 1024 and Q = 16, N = 1,000,064 rows), and
   times kernel, plain version and a one-call library yardstick (for the
   int8 kernel also ``torch._int_mm``, the s8 product alone, logged); then
   the int8 kernel over 10,000,000 x 1024 codes made on the card (bins
   bit-identical to the plain version at Q = 16, a call timed at Q = 16
   and 1024: a kernel time at BASELINE.json's scale, not a latency);
2. drives the serving path: ``SearchService`` with batching, a bulk load,
   concurrent ``vector_candidates`` calls with writes interleaved, recall@100
   against exact float32 ground truth, removed ids never served, the
   streaming kernel's launch count and the fused-dispatch count;
3. the same over an int8-mirrored ``DeviceCorpus(quantize=True)``;
4. the extract-kernel epilogue, identical to the sort epilogue;
5. generation serving at full width, in a card child (``CardChild``)
   beside 10.1's build, where this process JSON-encodes the chain's
   records and leaves the card idle (its kernel entries and launches
   come back in the child's result): Qwen2.5-0.5B (``QWEN25_05B``, bf16,
   weights from ``--seed``) behind ``GenerationEngine`` with the default
   ``GenServeConfig``. The ragged paged attention kernel is held against
   its plain version on the inputs of a real fused step (decode block
   L = 10, Tq = 1 and chunk block L = 1, Tq = 64) and timed; then 16
   requests of the qc/chat/rag mix of ``scripts/bench_generate.py`` from 8
   client threads: every request completes, the prefix cache hits, the
   kernel ran 24 x (steps + chunk steps) times, and every greedy token is
   the dense plain reference's (``prefill`` + ``decode_step``) or within
   GEN_MARGIN_TOL of it in the reference's logits. 5d: the engine's
   ``mode="dense"`` (a dense KV cache a sequence, torch ops, each
   sequence's decode step replayed from a captured CUDA graph) on 8 of the
   requests from 8 clients: no ragged launch, every token passing the
   dense reference at the cache width the engine chose, tok/s, ttft,
   per-token p50 and the longest request logged beside the paged run's. 5e: Heimdall's synchronous
   ``QwenGenerator`` over the same weights on 4 text prompts: ``generate``
   equal to ``qwen2.generate``'s tokens, which pass the dense reference,
   ``generate_stream``'s deltas joining to the same text, sampling at
   T = 0.8 repeating for a seed and changing for another;
6. (run after phase 10, with phase 7, so that 14b's replay child starts
   sooner) the fused cosine kernel through ``ops.fused_cosine_topk`` at
   Q = 1024 and Q = 16 on the 1,000,064 x 1024 float32 corpus buffer
   (tile_n 128, k = 100): held against its plain version (max |d| <=
   COSINE_TOL, top-100 ids equal but for swaps within it) and timed
   beside its bound and the float32 ``torch.matmul`` yardstick;
7. IVF serving at full width: a ``SearchService`` over the same vectors,
   batcher on, ``SearchConfig`` defaults. ``recluster()`` fits k-means
   (K = 707, 10 iterations, a 262,144-row sample), builds the layout and
   tunes ``n_probe`` against recall@100 >= 0.95; then 32 threads x 8
   queries through ``vector_candidates`` with the tuned plan: recall@100
   against exact float32 ground truth, client p50/p99 and qps beside phase
   2's full scan, fused dispatches, peak device memory, peak host RSS;
8. embed serving at full width: bge-m3 (``BGE_M3``, 24 layers, hidden 1024,
   bf16, weights from ``--seed``, ``HashTokenizer``) in a
   ``DeviceEmbedder`` behind ``ServingEngine`` with the default
   ``ServingConfig``. 65,536 texts of ``scripts/bench_embed.py``'s
   graph-node mix from 16 clients, 64 a call, after one untimed pack of
   each capacity class the mix reaches: embeddings/s, tokens/s, client
   p50/p99, pack p50, packs, pack efficiency, zero sheds, peak memory.
   Every embedding finite with norm 1; 256 of them, stratified over the
   kinds, within cosine 0.99 of the padded per-request path; a probe
   alone and inside a full pack likewise; the gap to float32 weights
   logged. Then a ``SearchService`` over the 65,536 embeddings serves 256
   stored texts embedded again, from 32 clients: recall@100 >= 0.95
   against an exact float32 scan, each text's own id in its top-100
   within 0.02 of the best, the bf16 streaming kernel launched (its count
   on a log line of its own; the ``kernels`` line keeps its five
   entries), fused dispatches. The embed engine stays up for phases 10
   and 9.

10. hybrid search through the port's ``DB``, run after phase 8 and before
   phase 9: ``DB(".chip_scratch/storage/db10", Config())`` on the card
   opens the durable chain ``open_storage`` assembles with the JAX
   defaults (``AsyncEngine`` over ``WALEngine`` over ``MemoryEngine``, the
   one ``cli serve`` opens) under the default database's namespace; its
   ``db.storage`` holds phase 8's 65,536 texts as nodes (``content`` and
   the phase-8 embedding) with 2-4 seeded edges a node, written, then
   flushed before the service serves (node and edge write rates, flush
   seconds, WAL bytes logged);
   ``db.set_embedder(CachedEmbedder(<phase 8's engine>))`` (the ``cli
   serve`` stack; it starts the DB's EmbedWorker), then ``db.search``, the
   DB's service, built, attached and indexed on first use with its
   options set through ``search.configure_defaults`` (write-behind and
   batching on, the IVF tuner off), as a server installs its config.
   32 clients
   x 4 ``search(query, limit=10)`` calls (40 candidates a leg; half stored
   texts, half their last two words) while 4 writers make 128 create /
   update / delete calls through the storage. Checks: each ranking equals
   ``fuse_rrf`` of its BM25 and vector legs; the vector leg's recall@40
   >= 0.95 against an exact float32 scan on the card; every stored text
   finds its node in the top 10 (>= 0.99 asserted); every acknowledged write
   is read back (an update through a cached ranking made before it) and a
   deleted node is never served; 64 repeats are cache hits with 0 launches
   of #2, one text update makes them miss, a recall's touches change
   neither the generation nor the corpus; 32 two-word searches reranked by
   a ``BGE_M3``-width cross-encoder (bf16) whose scores are within
   RERANK_TOL of the same forward in float32 and order the head; 32 with
   MMR equal to the host ``apply_mmr``. Logged: client p50/p99 and qps, the share of a
   search in embed, vector leg, BM25, fusion and enrich (spans taken in
   this script), the rerank forward, the uploader's runs and the query
   stall, #2's launches (a log line of their own), peak device memory.
   Then the telemetry plane over the live service: after ``refresh_hbm``
   ``nornicdb_hbm_bytes`` equals the bytes of every live corpus's tensors
   by component and is at most ``torch.cuda.memory_allocated()``; a
   ``deviceprof.capture_profile(2.0)`` while 8 threads search holds #2's
   launches (made on the batcher's thread); the tracer's ``search.embed``,
   ``search.rank`` and ``search.vector`` span p50s beside the script's.
   10.8, the learning loop: 512 new texts of phase 8's mix (from
   ``--seed`` + 1, none equal to a stored text) stored through
   ``db.store`` by 8 clients; the DB's EmbedWorker embeds them through
   phase 8's engine and ``_on_embedded`` feeds
   ``InferenceEngine.on_store``, whose lookups run #2; then 256 of them
   are marked pending again (a re-embed: each pair seen a second time
   reaches ``min_evidence``). Checks: the queue drains within 300 s; the
   worker processed every node with no failure or retry; no swallowed
   error was counted (``embed_queue``, ``inference.*``); each embedding is
   the CachedEmbedder's for its text; ``db.recall`` finds >= 0.99 of 128
   learned texts in its top 10, and ``DB.temporal``, read before 10.8,
   has recorded each of their touches (its tracker's access counts equal
   them node by node); every SIMILAR_TO edge joins nodes whose
   float32 cosine on the card is >= 0.85 - 1e-3, its confidence the mean
   of its observations. Logged: stores/s, embeddings/s,
   store-to-searchable and ``on_store`` p50/p99, suggestions, edges, #2's
   launches (a line of their own), and whether the debounced recluster
   fired. Last (10.7): the chain flushed, its counts, the writers' ids,
   every node's content and embedding and the inferred edges saved for
   phase 14;
   a fresh ``SearchService`` over the live chain (same config,
   ``build_indexes``) gives the row order and the ids and scores of 256
   stored embeddings at k = 100; the directory copied while no write is in
   flight (the image a kill then leaves). The chain is closed after phase
   9 (its close-time snapshot).
   10.9, Cypher through ``db.cypher`` on the card (the process-default
   device owner gating every offload; the in-memory DB's part in the card
   child of phase 5, after it, beside 10.1's build): 256 ``CALL
   db.index.vector.queryNodes('default', 10, $v)`` calls from 8 clients
   over phase 10's DB, each answer's ids and scores those of
   ``db.search.vector_candidates`` (#2 launches, no IVF plan serves); in
   an in-memory ``open_db("")`` on the card (synchronous storage, no
   result cache), 131,072 ``:Item`` nodes through ``UNWIND ... CREATE``
   (scores tied in runs of 16, exact in float32) and 8 ``ORDER BY
   i.score DESC LIMIT 100`` queries over >= 100,352 rows each (the top-k
   offload, ``torch.topk`` on the card), then 16,384 ``:Doc`` nodes with
   phase 8's embeddings and 8 ``ORDER BY vector.similarity.cosine(d.emb,
   $q) DESC LIMIT 10`` queries over >= 8,192 rows each (VectorTopK,
   ``graph_masked_scores`` on the card), at the default thresholds: each
   offload ``used`` once a query, never ``unavailable``, and 4 answers of
   each shape equal to the generic engine's (columnar off); plan-cache
   hits on the repeated shapes (``db.cypher_stats()``); Heimdall's
   ``query`` action on phase 10's DB counting its nodes and refusing a
   CREATE. Logged: each shape's p50 / p99 and each offload's device time
   (the ``deviceprof`` ledger).
   16, GDS and APOC through ``db.cypher`` on the card, after 10.9 (no
   kernel: ``index_add_``, ``scatter_reduce_`` and float32
   ``torch.matmul`` behind the device owner's gate). (a) over phase 10's
   DB, which it leaves as it was (node and edge counts before and after):
   ``gds.pageRank.stream`` over every node held to phase 12's bounds
   against a float64 power iteration over the adjacency snapshot's
   ``edge_arrays()``, its rows the snapshot's ids; ``gds.wcc.stream``
   equal to scipy's components; ``gds.degree.stream`` to ``np.bincount``;
   ``gds.linkPrediction.adamicAdar.stream`` from 8 seeded sources to
   ``score_pair``'s ranking over ``graph_view()``; ``apoc.path.expand``
   (8 sources) and ``apoc.neighbors.byhop`` (2) to depth 2 to a BFS;
   ``apoc.algo.pageRank(collect(i))`` over 4,096 ids within PR_L1_TOL of
   float64 on that subgraph; ``apoc.text`` / ``coll`` / ``map`` over
   10,000 rows; ``kalman.smooth`` / ``filter`` / ``predict`` equal to the
   filter module's ``Kalman``. (b) in a card child with phase 12, beside
   10.1's build (it reads nothing of phase 10's DB), in-memory DBs on the
   card: a Graph500 Kronecker graph of SCALE 13 through the storage API;
   ``gds.linkPrediction.suggest`` (the adjacency GEMMs on the card) for
   commonNeighbors equal to the numpy branch and for adamicAdar the same
   pairs but for ties within LINK_TOL; ``gds.fastRP.stream`` (128) unit
   norms for linked nodes and equal to a CPU executor's; Louvain, SCC,
   k-core and triangle counts equal to ``graph_algos`` over the
   snapshot's arrays; ``gds.graph.project`` / ``list`` / ``drop``;
   betweenness and closeness on the 512 highest-degree vertices'
   subgraph; ``apoc.create`` / ``merge`` / ``refactor`` /
   ``periodic.iterate`` with their counts, a trigger fired by 1,000
   creates, ``apoc.export.json.all`` under ``.chip_scratch/apoc`` and
   ``apoc.import.json`` into another DB with equal counts. Logged: each
   call's wall time and the PageRank, WCC and GEMM device time (CUDA
   events).
9. a checkpoint and GraphRAG answers: a ``QWEN25_05B`` checkpoint directory
   (weights from ``--seed``, a ``VocabTokenizer`` over phase 8's texts and
   the prompt header) written to a temporary directory and mounted with
   ``load_generator``, every tensor bit for bit; an ``EngineGenerator``
   over a ``GenerationEngine`` on it (sequences of 1,024 tokens); then
   ``GraphRAGService`` answers 16 stored phase-8 texts from 8 clients over
   phase 10's storage and hybrid service: ``recall`` is ``DB.recall`` (a
   hybrid ``search``, then a touch of each hit's access count through
   ``storage.update_node``, which leaves the index as it was). Every answer
   is paged, retrieves its own node and generates 1-64 tokens; answers
   after the first wave reuse the cached header pages; #2 and #5 both
   launch (their counts on a log line of their own); 4 answers' tokens
   pass the dense reference. The checkpoint is mounted as a JAX user
   mounts it: ``NORNICDB_ASSISTANT_MODEL=<dir>`` and
   ``genserve.configure(...)``, then ``db.heimdall`` (``load_generator`` on
   the card, then the DB's ``GenerationEngine`` and an
   ``EngineGenerator``); ``db.graphrag()`` answers with ``DB.recall``.
   Then 8 ``db.heimdall.chat`` completions from 8 clients, each paged
   through #5 with 1-64 new tokens, and the TemplateGenerator's answer of
   a DB with no checkpoint. The engine stays up for phase 17.
17. the serve surface, after phase 9 and before phase 10's DB closes.
   (a) the port's ``HttpServer`` and ``BoltServer`` over that DB, wired as
   ``python -m nornicdb_tpu_torch serve`` wires them: 8 HTTP clients send
   64 raw-vector searches, 32 text searches with distinct queries, 8
   transaction-API ``queryNodes`` reads and 2 GraphRAG answers; 8 Bolt
   sessions (HELLO, RUN, PULL) make 64 ``queryNodes`` calls. With no
   writer active, a raw-vector body equals what ``vector_candidates``
   answered it and a fresh call's ids (scores within #2's decode step), a
   text body equals ``db.search.search`` with the rank cache cleared, the
   Bolt and transaction rows equal ``db.cypher`` with the query cache
   cleared (ids; scores within #2's decode step), a GraphRAG answer is
   paged and retrieves its own node. A 429 is retried after its
   Retry-After, and the 429s and their longest run are logged. ``/health``,
   ``/metrics`` (parsed strictly), ``/admin/stats``, ``/admin/tpu/status``
   (the card's name) and ``/openapi.json`` are timed; ``/graphql``
   answers ``{ stats { nodes } }`` with the DB's count. Each kernel's
   launches in the traffic are logged, #2 and #5 above 0. (b) ``python -m
   nornicdb_tpu_torch serve --auth --embedder hash`` as a child process on
   the card over a fresh data directory: 401 for an unauthenticated
   search, 256 documents stored through the transaction API and embedded,
   16 searches answering their document first through #2 (the child's own
   launch counts, from its ``/admin/tpu/status``), ``/graphql`` counting
   the documents, ``GET /collections`` answering no collection, a GraphQL
   mutation refused for a viewer (401 "permission write denied", as the
   JAX server answers), a Bolt HELLO refused for a wrong password and
   accepted for the right one; with ``NORNICDB_GRPC_ENABLED`` and
   ``NORNICDB_QDRANT_GRPC_ENABLED`` on free ports, on the port's own gRPC
   transport (``server/grpcwire.py``; the card's machine has no grpcio),
   8 gRPC clients, each on a ``grpcwire.Channel`` of its own, send the
   HTTP searches' 8 vectors and 8 texts to the native gRPC search: each
   answer equals HTTP's (ids, content, scores at float32) and #2 is
   launched by them; the Qdrant gRPC service with ``--auth`` answers
   UNAUTHENTICATED without credentials and PERMISSION_DENIED to a
   viewer's Upsert, takes an admin's bearer token and basic auth, and
   shares its points with ``/collections/*`` both ways; SIGTERM to exit 0
   and a reopen holding the documents; ``serve --workers 2`` exits
   non-zero naming ROADMAP A6d. Beside phase 10's close, ``python -m
   nornicdb_tpu_torch decay recalculate`` and ``decay stats`` run over
   (b)'s data directory (phase 19).
18. GraphQL and the Qdrant REST API, started after phase 17. (a) before
   phase 10's DB closes: GraphQL over that DB behind a port
   ``HttpServer`` from 8 clients: 16 ``search`` fields held to
   ``db.search.search`` (rank cache cleared) in ids and scores, 16
   ``similar`` fields to ``db.search.vector_candidates`` without the node
   (ids, scores within #2's decode step), ``stats``, ``node``, ``nodes``,
   ``neighbors`` and a ``cypher`` ``queryNodes`` call held to the storage,
   ``db.neighbors`` and ``db.cypher``, introspection, and a document with
   a fragment, an alias, variables and ``@include`` / ``@skip``; #2
   launches. (b) in a child process on the card, started once (a) is
   done, that runs beside phase 10's close and phases 11 and 14 (host
   code under one interpreter lock of its own) and is collected after
   phase 14:
   Qdrant REST over a
   fresh in-memory port DB. A named-vector collection (1,024 points,
   ``dense`` 1,024 and ``small`` 64 wide): each name searched, its
   snapshot equal to what was upserted. A 1,024-wide Cosine collection
   loaded with phase 8's 65,536 embeddings as points (payload doc, group
   = doc % 16, the text's last word) from 4 client processes, 2 through
   REST in batches of 1,024 and 2 through the Qdrant gRPC service (a
   ``QdrantGrpcServer`` over the same registry) in Upserts of 512 (load
   wall time and each transport's points/s logged); 64 unfiltered
   searches from 8 clients through #2, half over gRPC (ids equal to the
   registry's own answer, scores within #2's decode step, recall@10 >=
   0.95 against an exact float32 scan; a gRPC answer equal to REST's for
   the same request), 16 searches filtered by group, half over gRPC (the
   exact filtered answer, ties within a bf16 step aside), count with and
   without a filter, a scroll through one group (a gRPC Count and Scroll
   page equal to REST's), retrieve, delete of 64 points (never served
   again, the count 65,472), the collection GETs, and GraphQL's five
   mutations held to the storage. The child's #2 launches are read from
   its own counts.
19. memory decay at full size on the card, in the card child of 16(b)
   and 12, after them, beside 10.1's build: an in-memory
   ``DB(Config(decay_enabled=True))`` (its ticker running) of 65,536
   memories x 1,024 (seeded unit vectors, #2's threshold, so its
   searches run #2) with seeded memory types, access counts, last accesses and
   importances; 16 searches; the manager's clock 120 days ahead,
   ``recalculate_all()``: every score within 1e-12 of this script's
   float64 copy of the formula (``decay_reference``), the archived count
   the one it predicts; the same searches give the same ids and scores
   after decay's ``update_node`` storm; ``CALL nornicdb.decay.info()``
   answers the enabled row; ``close()`` stops the ticker. And 17(b)'s
   ``decay`` commands (above).
11. training, after phase 10's close with the earlier phases' models
   released, beside 18(b)'s child (no kernel: torch ops, autograd and
   fused AdamW, as the JAX package trains through XLA). 11a:
   ``QWEN25_05B`` (494,032,768 bf16 parameters from ``--seed``) through
   ``training.make_lm_train_step`` at lr 1e-4 on 8 x 513-token windows
   of a seeded token stream; 11b: ``BGE_M3``
   (566,705,152) through ``make_train_step`` on 32 phase-8 texts and their
   ``_augment`` views (``HashTokenizer``, 128 tokens). Each: 3 warm-up
   steps, 20 timed (tokens/s, step p50/p99, the forward / backward /
   optimizer split by CUDA events, peak memory, model-FLOPs utilization
   against 989 TFLOP/s), 10 on one fixed batch whose loss must fall; the
   first step's loss and per-leaf gradients against a float32 copy of the
   parameters on the card; every parameter and optimizer-state tensor on
   the card. 11c: 11b's encoder written as a teacher checkpoint in
   ``train_encoder``'s layout, ``distill_encoder`` to 6 layers,
   ``load_embedder``, ``gate_student`` on the builtin suite (MRR - 0.1
   admits, MRR + 0.1 rejects), 4,096 texts through ``ServingEngine``
   beside phase 8's embeddings/s. 11d: ``train assistant`` and ``train
   encoder`` at the presets through the command line on the card, held
   to tests/test_pretrain.py's learning checks (capitals >= 8 of 12, loss
   below 0.3 of the first; top-1 for >= 2 of 3 queries); the trained
   assistant mounted in a DB (``NORNICDB_ASSISTANT_MODEL``): of its four
   trained status prompts through ``db.heimdall.chat`` at least one
   parses to the ``status`` action, whose dispatch returns the DB's node
   and edge counts.
12. graph offloads, in the card child of 16(b), after it, beside 10.1's
   build (no kernel: ``index_add_``, ``scatter_reduce_`` and float32
   ``torch.matmul``, as the JAX package leaves them to XLA). 12a: a
   Graph500 Kronecker graph (SCALE 20, edgefactor 16: 1,048,576
   vertices, 16,777,216 edges with self-loops and duplicates, from
   ``--seed`` on the card) and
   ``graph_algos.pagerank`` at its defaults, numpy in and out: end-to-end
   and device ms, ms an iteration against its bytes bound, the copies'
   share, held to a float64 numpy power iteration (L1 and the top 1,000
   ranks' relative error under stated bounds). 12b: ``connected_components``
   equal to scipy's components (each labelled by its smallest member),
   rounds and ms. 12c: a SCALE-13 Kronecker graph (8,192 nodes, 131,072
   edges) in a port ``MemoryEngine``, ``build_graph``, ``batch_scores``
   of all five methods on the card against ``use_device=False`` and
   ``top_candidates(adamicAdar, 20)`` against the CPU's.
14. the storage chain, after phase 11, beside 18(b)'s child while it
   runs (no kernel of its own: host code, and two
   C++ libraries built with ``g++`` from the port's copies in
   ``nornicdb_tpu_torch/storage/csrc``). 14a: phase 10's DB reopened by
   ``open_db`` from its close-time snapshot holds its counts, every
   acknowledged write (content, embedding bit for bit), 10.8's learned
   nodes and inferred edges and no deleted id; its ``db.search`` on the
   card has the fresh service's row order and gives its 256 answers bit
   for bit through kernel #2. 14b: the crash image (no
   snapshot) replays its whole WAL to the same state; records/s, then
   ``compact()``, close and reopen. 14c: two children that never touch
   CUDA crash by SIGKILL at a seeded point: the default chain (every write
   before its flush back, the later ones a prefix of their order, the WAL
   intact once its first append repairs a torn tail) and
   ``async_writes=False, wal_sync=True`` with the native codec (every
   acknowledged write back; the child's fsync p50). 14d: the adjacency
   snapshot of the recovered chain: ``edge_arrays()`` equal to a scan,
   PageRank (phase 12's bounds against float64) and WCC (scipy's) on the
   card, again after 1,000 edges created and 1,000 deleted through the
   chain; ``linkpredict.build_graph`` served by the snapshot and equal to
   its scan; BFS from 16 starts against ``bfs_distances_csr``. 14e: the
   segment store keeps 4,096 documents across a reopen and serves 64
   vector queries bit for bit as a ``MemoryEngine`` with the same
   documents in the same order; a ``DatabaseManager`` over the chain keeps
   two databases with shared ids apart (counts, search answers) and brings
   both and an alias back after a reopen. The data directories' sizes are
   logged and the directories deleted.
15. the device owner, after phase 14: a private ``BackendManager`` over
   ``FakeHooks("hang")`` (acquire timeout 0.5 s) and a 65,536 x 1024
   corpus on the card. A search raises ``DeviceUnavailable`` within 1.5 s
   (the port's one policy, "fail"; nothing answers from the host); after
   ``set_mode("ok")`` the manager goes through RECOVERING to READY with one
   recovery and the card answers with the ids a corpus of the same rows
   under the process default gave; a ``CypherExecutor`` behind the same
   manager refuses ``gds.pageRank.stream`` while it hangs and serves it
   on the card after the recovery. Then the card hangs again: the manager
   degrades, a search raises at once, a row written meanwhile lands on
   the host; after the second recovery the card answers with that row,
   patched into the resident buffer with no whole-corpus upload. A second
   private manager with the real hooks (CUDA init and a round trip on its
   own stream) acquires the card and reports its name.
13. the registry, last: the port's ``REGISTRY`` rendered and parsed
   strictly (a parser of this script's); non-zero program-ledger samples
   for search/dense, search/ivf, serving/embed and genserve/ragged, the
   program-time histogram, serving batches, search batch sizes, device
   syncs, IVF tunes and cost-model observations; the generated-token
   counter equal to the engines' own counts (phases 9 and 17: the card
   children's engines count in their own processes); the cost
   model's median relative error, every phase's predicted-deadline sheds
   (phases 8 and 10 retry a shed call with backoff) and the tracer's
   cost a span on this host; the storage families (WAL append, async
   flush seconds and ops, adjacency maintenance) non-zero, and phase 14's
   traced write holding ``wal.append``, ``storage.flush`` and
   ``adjacency.build`` spans; ``nornicdb_embed_retries_total`` at 0, no
   swallowed error of the embed worker, inference or the checkpoint load,
   and Heimdall's named metrics (registered by phase 9 as the JAX HTTP
   server registers them) counting phase 9's chats. The process-default
   device owner, started before phase 1 (it acquires the card on its own
   thread and probes it every 5 s with a kernel on its own stream, policy
   "fail"), READY one-hot, with no degrade, acquire timeout or fallback;
   its probe count, latency p50 / max (the probe kernel's device time,
   held under half the 1.0 s threshold) and failure reasons logged; the ``nornicdb_backend_*`` and
   ``nornicdb_cypher_*`` families rendered.

The data is a Gaussian mixture made on the card with torch from ``--seed``
(queries with numpy): 10,000 centres with 100 rows each (shuffled), so
each query's true top-100 is separable from the rest. Queries are noisy
copies of rows.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON (times, bounds, launches). Every ``ms`` there is
the time of a call from Python between CUDA events (``cuda_ms``). The
extract kernel, the ragged attention kernel and their yardsticks take
microseconds, so the host's launch work can set that time: their entries
also carry the device time of a call from CUDA-graph replays (``graph_ms``)
as ``device_ms`` and ``library_device_ms``. Phases 1 and 6 also print the
int8 and bf16 streaming, extract and fused cosine kernels' ptxas registers,
shared memory and spills, and phases 1, 5 and 6 each redesigned kernel's share of
its bound, its launch plan and its first version's time copied from
PERF.md (not measured here); phase 1 times the sort epilogue
(``topk_lowest_index``) over the same bins; ``--profile`` writes
``chiprun_out/profile_embed.txt`` for phase 8. Any failed check raises and
the script exits non-zero without that line. Without CUDA it exits 2.
Matmul precision is pinned to full float32 (no TF32) for every reference,
and bf16 GEMMs to float32 reductions.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import os
import re
import resource
import subprocess
import sys
import threading
import time

import numpy as np

H100_BF16_OPS = 989e12   # dense tensor-core bf16, per second
H100_INT8_OPS = 1979e12  # dense tensor-core int8
H100_FP32_OPS = 67e12    # outside the tensor cores
H100_BYTES = 3.35e12     # HBM3 bytes per second

# the Graph500 Kronecker initiator (graph500.org, "Graph 500 Benchmarks",
# section 3); D = 1 - A - B - C = 0.05
GRAPH500_A, GRAPH500_B, GRAPH500_C = 0.57, 0.19, 0.19

# the main path's size: bench.py's headline search (1M x 1024, top-100)
N, DIMS, K_TOP = 1_000_000, 1024, 100
# kernel #3's timing at BASELINE.json's "p50 top-100 @10M vectors" scale
N_10M = 10_000_000
REPS = 6  # timed calls of each kernel (a third of that for the slow ones)

# phase 5: the generation mix of scripts/bench_generate.py (kind,
# prompt_len, max_new, weight, shared_prefix_len), 16 requests, 8 clients
# (32 until phase 17 came: its dense reference checks every token, ~40 s
# at 32; no later phase reads them; PERF.md section 4)
GEN_MIX = (
    ("qc", 12, 16, 0.25, 0),
    ("chat", 24, 32, 0.30, 16),
    ("rag", 80, 48, 0.45, 48),
)
GEN_REQUESTS, GEN_CLIENTS = 16, 8
# every greedy token of the engine must have a dense-reference logit within
# this of the reference's largest. The engine (ragged kernel, fused F-row
# GEMMs) and the reference (plain attention, 1-row GEMMs) round bf16 at the
# same points but sum in other orders; phase 5a asserts over GEN_PROBES
# prompt sets that a real fused step's logits lie within GEN_MARGIN_TOL / 2
# of the dense path's (0.0261-0.0286 for seeds 0-3 on an H100 80GB HBM3),
# so only a token within GEN_MARGIN_TOL of the best can be chosen in its
# place
GEN_MARGIN_TOL = 0.06
GEN_PROBES = 4
# phase 5d: the engine's dense mode serves the first 8 of phase 5's requests
# from 8 clients; phase 5e: QwenGenerator on 4 text prompts (words of
# EMBED_WORDS) of these lengths, SYNC_NEW tokens each, sampling at
# SYNC_TEMPERATURE
DENSE_REQUESTS = 8
SYNC_PROMPT_WORDS, SYNC_NEW, SYNC_TEMPERATURE = (8, 24, 40, 64), 32, 0.8
# phase 8: scripts/bench_embed.py's graph-node text mix (kind, weight,
# min_words, max_words) over its 38-word list; each text ends with one
# unique word. 65,536 texts from 16 closed-loop clients, 64 a call
EMBED_MIX = (
    ("title", 0.85, 2, 5),
    ("description", 0.12, 10, 18),
    ("paragraph", 0.03, 40, 60),
)
EMBED_WORDS = (
    "graph node edge vector search index memory storage engine query "
    "batch token device shard corpus embed serve latency throughput "
    "append commit probe replica quorum trace metric histogram cache "
    "segment packed ragged schedule deadline admission queue stream"
).split()
EMBED_TEXTS, EMBED_CLIENTS, EMBED_CALL = 65_536, 16, 64
# packed against per-request bf16 embeddings: the JAX package's own bound
# (tests/test_serving.py, bf16 config)
EMBED_COS = 0.99
# 256 stored texts, stratified over the kinds, checked against the padded
# path; 256 more embedded again as search queries
EMBED_CHECK, EMBED_QUERIES = 256, 256
# a query's own text must score within this of its best hit: the same text
# in two packs differs by bf16 rounding only
OWN_SCORE_TOL = 0.02
# phase 9: GraphRAG answers to 16 stored phase-8 texts from 8 clients (32
# until phase 17 came; two waves still test the cached header) over a
# checkpoint written and loaded by the run; each node has 2-4 outgoing
# edges. GraphRAG budgets its prompt in whitespace words (max_seq_tokens -
# 72) and the tokenizer splits punctuation, so a packed prompt (the 92-word
# header in 109 tokens, 5 hits of up to 200 characters, up to 8 edges a hit
# at 7 tokens each) outgrows its budget: ~250-300 tokens where the default
# sequence holds 256, up to ~660 in all. The engine keeps a prompt's tail,
# so the shared header would be cut away. Sequences of 1,024 tokens hold
# every such prompt whole; the pool holds 8 of them
RAG_QUESTIONS, RAG_CLIENTS = 16, 8
RAG_EDGES = (2, 4)
RAG_SEQ_TOKENS = 1024
RAG_CHECKED = 4  # answers whose tokens are held against the dense path
# phase 10: hybrid search over phase 8's texts in a MemoryEngine: 32
# clients x 4 searches of limit 10 (40 candidates a leg), half stored texts,
# half their last two words, while 4 writers make 128 create / update /
# delete calls; 64 repeats for the rank cache; 32 two-word searches
# reranked by a BGE_M3-width cross-encoder (20 candidates) and 32 with MMR
# (8 searches a client and 256 writes until, with phase 18, the run passed
# 1,200 s on a slower host: no later phase reads them; PERF.md section 4)
HYBRID_CLIENTS, HYBRID_PER_CLIENT, HYBRID_LIMIT = 32, 4, 10
HYBRID_WRITERS, HYBRID_WRITES = 4, 128
HYBRID_REPEATS, HYBRID_RERANK, HYBRID_MMR = 64, 32, 32
# a phase-10 client retries a shed embed (ResourceExhausted) with backoff:
# 32 clients' BM25 holds the interpreter lock, so the embed engine's
# dispatcher can miss ServingConfig's 2 s deadline under this load, and the
# cost model, taught those wall times, sheds at submit until one of every 8
# would-be sheds is let through as a probe: on an H100 host one client was
# shed 8 times running (~3.5 s of backoff) and gave up, so a client waits
# up to 16 tries (~11.5 s); each phase logs the longest run of sheds one
# call met (_Backoff.longest)
BACKOFF_TRIES = 16
# cross-encoder scores with bf16 weights against the same forward with the
# weights in float32, both on the card: the bound of the port's bf16 bge-m3
# against the JAX one (tests/test_torch_bge_m3.py); the head's weights are
# normal * 0.02 over unit embeddings, so a score moves by at most
# 0.02 * sqrt(1024) * |d embedding|. Phase 10 logs the gap it measured.
RERANK_TOL = 0.0035
# fused cosine kernel vs plain version: both float32 (no TF32); the kernel
# scales the dot product by the row's inverse norm where the plain version
# scales the row first, and sums in another order
COSINE_TOL = 1e-5
# ragged kernel vs plain version: float32 1e-5, bfloat16 2**-7 relative and
# absolute (probabilities are rounded to bf16 before P.V, so a one-ulp
# float32 difference moves one probability by a bf16 ulp)
ATTN_TOL_BF16 = 2.0 ** -7
# the first versions of the four redesigned kernels: the time of a call at
# Q = 1024 / 16 (#5: at the decode / chunk block) on an H100 80GB HBM3 at
# 700 W, copied from the "First version ms" column of PERF.md's kernel
# table for the log lines only (not measured by this run, so not in the
# kernels JSON)
FIRST_VERSION_MS = {"extract_topk": {1024: 0.2008, 16: 0.0588},
                    "fused_cosine_scores": {1024: 64.14, 16: 3.181},
                    "streaming_topk_bf16": {1024: 16.358, 16: 3.039},
                    "streaming_topk_int8": {1024: 7.271, 16: 1.342},
                    "ragged_paged_attention": {"decode": 0.03270,
                                               "chunk": 0.03495}}


# phase 11: training at full width. 11a: QWEN25_05B LM steps over LM_BATCH
# windows of LM_WINDOW tokens of a seeded token stream (4,096 predicted
# tokens a step); 11b: BGE_M3 InfoNCE over ENC_PAIRS phase-8 texts and their
# _augment views, HashTokenizer, padded to ENC_LEN tokens. Each runs
# TRAIN_WARMUP steps, TRAIN_TIMED timed ones, then TRAIN_FIXED on one fixed
# batch, AdamW at LM_LR / ENC_LR. The 24-layer post-LN encoder collapses
# under AdamW at 1e-4 with no warm-up (every embedding the same, the loss
# at ln 32 from the fifth step on an H100; neither package's optimizer has
# a warm-up), and trains at 3e-5 and 1e-5, so 11b runs at 1e-5
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FIXED = 3, 20, 10
LM_LR, ENC_LR = 1e-4, 1e-5
LM_BATCH, LM_WINDOW = 8, 513
ENC_PAIRS, ENC_LEN = 32, 128
# over its TRAIN_FIXED steps the fixed batch's LM loss falls by at least
# LM_FIXED_DROP nats, and its InfoNCE loss to at most ENC_FIXED_RATIO of
# its first value: a model that does not learn moves either by rounding
LM_FIXED_DROP, ENC_FIXED_RATIO = 0.5, 0.5
# --profile traces this many more steps of each (profile_train)
TRAIN_PROFILED = 2
# the first step in bf16 against the same step on a float32 copy of the
# parameters on the card: the loss's relative gap, each leaf's gradient
# cosine. A leaf whose float32 gradient norm is below SIGNAL_FLOOR of the
# largest leaf's is held by its gap's norm instead: bge-m3's key biases
# have an exact gradient of zero (softmax is invariant to adding q.b_k to
# a row), and at random init its deep post-LN stack's attention sees
# near-identical keys, so the q/k gradients of many layers are within a
# few 1e-4 of zero too: there the cosine compares bf16 rounding noise
FIRST_LOSS_RTOL, FIRST_GRAD_COS, SIGNAL_FLOOR = 1e-2, 0.98, 1e-3
# 11c: a DISTILL_LAYERS student of 11b's encoder, DISTILL_STEPS steps over
# DISTILL_CORPUS phase-8 texts, then STUDENT_TEXTS texts served
DISTILL_LAYERS, DISTILL_STEPS, DISTILL_CORPUS = 6, 30, 4096
STUDENT_TEXTS = 4096
# phase 12: graph offloads. 12a and 12b over a Graph500 Kronecker graph of
# GRAPH_SCALE and GRAPH_EDGEFACTOR (1,048,576 vertices, 16,777,216 directed
# edges): PageRank at the JAX defaults (0.85, 20 iterations), one warm-up
# call and GRAPH_CALLS timed ones, held to a float64 numpy power iteration
# over the same edges: the L1 distance at most PR_L1_TOL, the largest
# relative error of the PR_TOP highest ranks at most PR_TOP_REL_TOL (the
# card adds a hub's ~1e5-1e6 float32 contributions by atomics in no fixed
# order, ~sqrt(K) x 6e-8 relative); WCC equal to scipy's components
# exactly. 12c: link prediction over a port MemoryEngine holding a
# Kronecker graph of LINK_SCALE (8,192 nodes, 131,072 edges; at 65,536
# nodes the dense adjacency would take 17 GB on the host): on the card
# against use_device=False, the integer methods exactly, the weighted ones
# within LINK_TOL (relative and absolute: float32 sums in another order)
# (SCALE 22 until phase 17 came: its 80.4 s paid for part of the new
# phase, and no later phase reads this graph; PERF.md section 4)
GRAPH_SCALE, GRAPH_EDGEFACTOR, GRAPH_CALLS = 20, 16, 5
PR_L1_TOL, PR_TOP, PR_TOP_REL_TOL = 2e-4, 1000, 1e-3
LINK_SCALE, LINK_LIMIT, LINK_TOL = 13, 20, 1e-5
# 10.8, the learning loop: LEARN_TEXTS new texts of phase 8's mix (from
# --seed + 1, each ending in a word no stored text has) stored through
# DB.store by LEARN_CLIENTS clients; the pending queue must drain within
# LEARN_DRAIN_S seconds; LEARN_RECALLS of them recalled by their text;
# LEARN_REEMBED marked pending again (a re-embed: on_store observes each
# pair a second time, which min_evidence = 2 needs for an edge). Every
# SIMILAR_TO edge joins nodes whose float32 cosine on the card is at least
# the DB's similarity_threshold less SIM_TOL (the vector leg's scores are
# exact float32 rescores)
# (8,192 texts took the run to 1,157.6 s on an H100 against the 1,080 s it
# must stay under; with 10.9 and phase 15 added, 4,096 texts and 256
# recalls took it to 1,143.5 s, so 2,048 and 128; with phase 16 added,
# 1,145.7 s on a slower host, so 1,024; with phase 18, past 1,200 s on a
# slower host, so 512; PERF.md section 4)
LEARN_TEXTS, LEARN_CLIENTS, LEARN_DRAIN_S = 512, 8, 300.0
LEARN_RECALLS, LEARN_REEMBED, SIM_TOL = 128, 256, 1e-3
# phase 9: Heimdall chat completions from CHAT_CLIENTS clients through
# db.heimdall (the engine over the mounted checkpoint), CHAT_TOKENS each
CHATS, CHAT_CLIENTS, CHAT_TOKENS = 8, 8, 64
# phase 10's profile capture: seconds, and the threads searching meanwhile
CAPTURE_SECONDS, CAPTURE_THREADS = 2.0, 8
# tokens each generation engine of the run generated, by phase (phase 13
# holds nornicdb_genserve_generated_tokens_total to their sum), and the
# predicted-deadline sheds each phase's clients retried
GEN_COUNTED: dict = {}
PREDICTED_SHEDS: dict = {}
# phase 10 stores its corpus in the chain open_storage assembles (the JAX
# defaults: AsyncEngine -> WALEngine -> MemoryEngine) under CHAIN_DIR/db10,
# which phase 14 reopens; every data directory lives under CHAIN_DIR and is
# deleted at the end of phase 14. VEC_QUERIES stored embeddings (k = VEC_K)
# held bit for bit between a fresh service over the live chain and one over
# the recovered chain; 14c hands CRASH_DOCS documents to each crash child,
# the default chain's writes CRASH_LATE more after its flush and the
# synchronous one up to CRASH_SYNC, each killed at a seeded point; 14d
# creates and deletes ADJ_MUTATIONS edges and runs BFS from ADJ_STARTS
# starts; 14e queries the segment store SEG_QUERIES times and fills two
# databases with MDB_DOCS documents each. CHAIN_MIN_FREE: the disk the
# chain's directories need (the WAL, its snapshot and the crash image of
# phase 10 take ~4 GB). CRASH_DOCS went from 8,192 to 4,096 when phase
# 16 took the run to 1,145.7 s (14c and 14e write them; PERF.md section 4)
CHAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".chip_scratch", "storage")
VEC_QUERIES, VEC_K = 256, 100
CRASH_DOCS, CRASH_LATE, CRASH_SYNC = 4096, 1024, 2048
ADJ_MUTATIONS, ADJ_STARTS = 1000, 16
SEG_QUERIES, MDB_DOCS = 64, 512
CHAIN_MIN_FREE = 8 << 30
# trace ids whose spans phase 13 reads (phase 14's traced write and build)
TRACED: dict = {}
# 10.9, Cypher: CYPHER_VEC_QUERIES db.index.vector.queryNodes calls from
# CYPHER_CLIENTS clients over phase 10's DB; CYPHER_ITEMS :Item nodes and
# CYPHER_DOCS :Doc nodes (phase 8's embeddings) in an in-memory DB on the
# card, CYPHER_SHAPE_QUERIES queries of each offload shape, CYPHER_CHECKED
# of them held against the generic engine; CYPHER_BATCH rows an UNWIND
CYPHER_VEC_QUERIES, CYPHER_CLIENTS = 256, 8
CYPHER_ITEMS, CYPHER_DOCS = 131_072, 16_384
# (32 shape queries until phase 17 came, 16 until phase 18 came; each
# shape keeps its 4 checks)
CYPHER_SHAPE_QUERIES, CYPHER_CHECKED, CYPHER_BATCH = 8, 4, 8192
# phase 16, GDS and APOC through db.cypher: (a) over phase 10's DB, link
# prediction and depth-2 paths from GDS_SOURCES seeded nodes, hop levels
# from GDS_HOP_SOURCES of them (apoc.neighbors.byhop reads every edge of
# the DB a call: 2.5 s over 197,628 edges on the H100's host),
# apoc.algo.pageRank over GDS_SUBSET of its nodes, pure APOC functions over
# GDS_ROWS rows, the Kalman functions over a seeded series of GDS_SERIES;
# (b) a Graph500 Kronecker graph of GDS_SCALE (phase 12c's size) in an
# in-memory DB, FastRP at GDS_DIM, betweenness and closeness (host Brandes,
# O(n m): 1.70 s and 1.09 s over its 56,583 edges on the H100's host, where
# the whole graph would take minutes) over the subgraph of the GDS_CENTRAL
# highest-degree vertices, a trigger fired by GDS_TRIGGERED creates, and
# the export written under APOC_DIR
GDS_SOURCES, GDS_HOP_SOURCES, GDS_SUBSET = 8, 2, 4096
GDS_ROWS, GDS_SERIES = 10_000, 256
GDS_SCALE, GDS_DIM, GDS_CENTRAL, GDS_TRIGGERED = LINK_SCALE, 128, 512, 1000
APOC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_scratch", "apoc")
# phase 17, the serve surface (python -m nornicdb_tpu_torch serve). (a) The
# port's HttpServer and BoltServer over phase 10's DB, wired as cmd_serve
# wires them: SERVE_CLIENTS HTTP clients send SERVE_VECTORS raw-vector
# searches (stored embeddings with noise, limit SERVE_K), SERVE_TEXTS text
# searches with distinct queries, SERVE_TX transaction-API reads
# (queryNodes) and SERVE_RAG GraphRAG answers; SERVE_CLIENTS Bolt sessions
# (HELLO, RUN, PULL) make SERVE_BOLT queryNodes calls. (b) The command as a
# child process on the card, with --auth and the hash embedder
# (SERVE_DIMS), over SERVE_DOCS documents stored through the transaction
# API; its launcher lowers similarity.STREAMING_MIN_ROWS to that corpus
# before it calls cli.main, so its searches run #2. SIGTERM must end it
# with exit code 0 within SERVE_EXIT_S seconds
SERVE_CLIENTS, SERVE_K = 8, 10
# (64 text searches until phase 18 came; PERF.md section 4)
SERVE_VECTORS, SERVE_TEXTS, SERVE_TX, SERVE_RAG = 64, 32, 8, 2
SERVE_BOLT = 64
SERVE_DOCS, SERVE_DIMS, SERVE_EXIT_S = 256, 64, 60.0
# (b) also serves the native gRPC search and the Qdrant gRPC services on
# free ports, on the port's own transport (server/grpcwire.py): its
# SERVE_CLIENTS gRPC clients, each on a grpcwire.Channel of its own, send
# as many raw-vector searches as (b)'s HTTP ones, on the same vectors,
# searches and the same text searches; SERVE_QDRANT_POINTS points go
# through Qdrant gRPC (bearer and basic auth) and REST
SERVE_QDRANT_POINTS = 16
# phase 18, GraphQL and Qdrant REST. (a) GraphQL over phase 10's DB:
# GQL_SEARCHES search and GQL_SIMILAR similar fields (limit SERVE_K) from
# SERVE_CLIENTS clients. (b) A collection of QDRANT_POINTS points (phase
# 8's embeddings; QDRANT_GROUPS payload groups) upserted in batches of
# QDRANT_BATCH from QDRANT_LOADERS client processes, QDRANT_SEARCHES
# unfiltered and QDRANT_FILTERED filtered searches from SERVE_CLIENTS
# clients, QDRANT_DELETED points deleted; a named-vector collection of
# QDRANT_NAMED points (vectors "dense", 1,024 wide, and "small",
# QDRANT_SMALL wide)
GQL_SEARCHES, GQL_SIMILAR = 16, 16
QDRANT_POINTS, QDRANT_BATCH, QDRANT_LOADERS = 65_536, 1024, 4
QDRANT_GROUPS, QDRANT_SEARCHES, QDRANT_FILTERED = 16, 64, 16
QDRANT_DELETED, QDRANT_NAMED, QDRANT_SMALL = 64, 1024, 64
# 18(b) over gRPC too: QDRANT_GRPC_LOADERS of the loaders upsert through
# the Qdrant gRPC service in batches of QDRANT_GRPC_BATCH (1,024 points x
# 1,024 float32 would pass the 4 MiB message limit the port keeps from
# grpcio), so half the points come from each transport; the odd-numbered
# unfiltered and filtered searches go over gRPC
QDRANT_GRPC_LOADERS, QDRANT_GRPC_BATCH = 2, 512
# phase 19, memory decay at full size, in the card child of 16(b) and 12
# (which, without it, ended ~60 s before the child of 5 and 10.9): an
# in-memory DB(Config(decay_enabled=True)) of DECAY_NODES
# memories x DIMS on the card (seeded unit vectors: #2's threshold, so its
# searches run #2), the manager's clock moved DECAY_AHEAD_DAYS ahead;
# DECAY_QUERIES searches before and after the recalculation; every score
# within DECAY_TOL of this script's float64 copy of the formula (numpy's
# exp and log against libm's may differ in the last bit)
DECAY_NODES = 65_536
DECAY_AHEAD_DAYS, DECAY_QUERIES, DECAY_TOL = 120.0, 16, 1e-12
# phase 15, the device owner: a private manager over FakeHooks, a corpus of
# OWNER_ROWS x DIMS on the card, OWNER_QUERIES queries
OWNER_ROWS, OWNER_QUERIES = 65_536, 16
# the process-default device owner (started first, read by phase 13)
OWNER: dict = {}
# the second card child beside 10.1's build starts this many seconds after
# the first, which times the ragged kernel in its first ~15 s (phase 5a):
# the timing sees no other process's work on the card
CHILD_DELAY_S = 20.0


def log(*a) -> None:
    print(*a, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def exact_matmuls() -> None:
    """Full float32 matmuls (no TF32) and float32 reductions in bf16
    GEMMs, for every reference of the run and of its card children."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, calls: int, runs: int = 5) -> float:
    """The median over ``runs`` of ``cuda_ms(fn, calls)``. A call of tens of
    microseconds is set by host work, and one hiccup of the host can move
    the mean of a short run by half."""
    return float(np.median([cuda_ms(fn, calls) for _ in range(runs)]))


def graph_ms(fn, calls: int, replays: int = 6) -> float:
    """Mean device time of one call of ``fn`` in ms: ``calls`` calls
    captured in a CUDA graph, replayed ``replays`` times between CUDA
    events. For a kernel of a few microseconds, back-to-back calls from
    Python (``cuda_ms``) time the host's launch work, not the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: the device owner's probe thread may copy and
    # synchronise its own stream while this thread captures
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_us(fn, calls: int = 3000) -> float:
    """Mean host time of one call of ``fn`` in microseconds."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def launch_host_costs(K, device) -> dict:
    """Host microseconds of what ``kernels._launch`` does before each
    launch, beside the public calls it avoids (a kernel of a few
    microseconds waits for them)."""
    import torch

    def switch():
        with torch.cuda.device(device):
            pass

    return {
        "raw_stream": host_us(lambda: K._current_stream(device)),
        "current_stream": host_us(lambda: torch.cuda.current_stream(device).cuda_stream),
        "device_check": host_us(lambda: device.index == torch.cuda.current_device()),
        "device_switch": host_us(switch),
    }


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` report: its registers,
    shared memory and spill bytes."""
    if not report:
        return ["no report: the library was built before this run"]
    out, fn, spill = [], "", ""
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info") and "Used" in line and fn:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn = ""
    return out


def kronecker_edges(scale: int, edgefactor: int, seed: int,
                    device: str = "cpu"):
    """The Graph500 Kronecker generator (graph500.org, "Graph 500
    Benchmarks", section 3): 2**scale vertices and edgefactor * 2**scale
    directed edges, each edge's endpoint bits drawn from the initiator
    A = 0.57, B = 0.19, C = 0.19 (D = 0.05), then the vertex labels and
    the edge order permuted; self-loops and duplicate edges are kept, as
    the specification keeps them. Seeded ``torch.Generator`` on
    ``device``. Returns (src, dst) int32 tensors on ``device``."""
    import torch

    n, m = 1 << scale, edgefactor << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ab = GRAPH500_A + GRAPH500_B
    c_norm = GRAPH500_C / (1.0 - ab)
    a_norm = GRAPH500_A / ab
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=gen, device=device) > thresh
        src |= i_bit.to(torch.int32) << bit
        dst |= j_bit.to(torch.int32) << bit
    del i_bit, j_bit, thresh
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    src, dst = perm[src.long()], perm[dst.long()]
    order = torch.randperm(m, generator=gen, device=device)
    return src[order], dst[order]


def make_data(seed: int, n: int, d: int, per: int = 100) -> np.ndarray:
    """(n, d) float32 unit rows: n // per centres, `per` noisy rows each,
    shuffled. Row noise has norm 0.5, so rows of one centre score ~0.8
    with each other and ~0 with the rest. Made on the card from ``seed``
    (numpy took ~25 s for 1M x 1024 on an H100's host) and copied to the
    host, where the service's bulk load takes them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn(n // per, d, generator=g, device="cuda")
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    assign = torch.randperm(n, generator=g, device="cuda") % (n // per)
    out = np.empty((n, d), np.float32)
    step = 1 << 18
    for i in range(0, n, step):
        j = min(i + step, n)
        chunk = centres[assign[i:j]]
        chunk += torch.randn(j - i, d, generator=g, device="cuda") * (
            0.5 / np.sqrt(d))
        chunk /= torch.linalg.vector_norm(chunk, dim=1, keepdim=True)
        out[i:j] = chunk.cpu().numpy()
    del centres, assign, chunk
    torch.cuda.empty_cache()
    return out


def make_queries(rng, data: np.ndarray, rows: np.ndarray) -> np.ndarray:
    q = data[rows] + rng.standard_normal(
        (rows.size, data.shape[1]), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(data.shape[1]))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def ground_truth(qs: np.ndarray, dev, valid, k: int) -> list[set]:
    """Exact float32 top-k row sets over the resident corpus."""
    import torch

    qt = torch.from_numpy(qs).to(dev.device)
    scores = qt @ dev.T
    scores = torch.where(valid[None, :], scores, float("-inf"))
    idx = torch.topk(scores, k, dim=1).indices.cpu().numpy()
    return [set(r.tolist()) for r in idx]


def recall(results, gt_ids) -> float:
    return float(np.mean([
        len({i for i, _ in res} & gt) / len(gt) for res, gt in zip(results, gt_ids)
    ]))


def phase_kernels(K, R, dev, valid, c_i8, c_scale, qs_all, k, reps):
    """Each kernel against its plain version at the serving shapes; times."""
    import torch

    from nornicdb_tpu_torch.ops import _build

    n, d = dev.shape
    tile = K.pick_tile_n(n)
    rows = min(K.streaming_rows_for(k, tile), n // tile)
    n_tiles, rows, tile_bits = K.streaming_geometry(n, tile, rows)
    b = rows * tile
    kpad = -(-k // K.LANE) * K.LANE
    log(f"[kernels] N={n} D={d} tile_n={tile} rows={rows} tile_bits={tile_bits} "
        f"bins={b} k={k}")
    for name in ("streaming_topk", "streaming_topk_bf16", "extract_topk"):
        for line in ptxas_summary(_build.ptxas_reports.get(name, "")):
            log(f"[kernels] {name} ptxas: {line}")
    costs = launch_host_costs(K, dev.device)
    log("[kernels] host us before a launch: " + " ".join(
        f"{a}={v:.3f}" for a, v in costs.items()) + " (kernels._launch takes "
        "raw_stream and device_check in place of current_stream and "
        "device_switch)")
    entries = []
    for q in (min(1024, len(qs_all)), 16):
        qt = torch.from_numpy(qs_all[:q]).to(dev.device)
        q_i8, q_scale = K.quantize_rows(qt)

        # -- #2 bf16 streaming bins
        bins_k = K.streaming_bins(qt, dev, valid, tile, rows)
        bins_p = R.streaming_bins_bf16(qt, dev, valid, tile, rows, tile_bits)
        sync()
        dec = dict(k=k, n=n, rows=rows, tile_n=tile, tile_bits=tile_bits)
        vk, ik = K._decode_packed(bins_k, **dec)
        vp, ip = K._decode_packed(bins_p, **dec)
        err2 = float((vk - vp).abs().max())
        tol2 = 2.0 ** (tile_bits - 21) + 1e-5
        rec2 = float(np.mean([
            len(set(a.tolist()) & set(c.tolist())) / k
            for a, c in zip(ik.cpu().numpy(), ip.cpu().numpy())
        ]))
        log(f"[kernels] bf16 Q={q}: max|dv|={err2:.3g} (tol {tol2:.3g}) "
            f"recall vs plain={rec2:.4f} bins equal={float((bins_k == bins_p).float().mean()):.6f}")
        assert err2 <= tol2, ("bf16 streaming kernel values", err2, tol2)
        assert rec2 >= 0.99, ("bf16 streaming kernel recall vs plain", rec2)

        # -- #3 int8 streaming bins: bit-identical
        bins8_k = K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile, rows)
        bins8_p = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile, rows,
                                        tile_bits)
        sync()
        assert torch.equal(bins8_k, bins8_p), (
            "int8 bins differ", int((bins8_k != bins8_p).sum()))
        log(f"[kernels] int8 Q={q}: bins bit-identical")

        # -- #4 extract over the kernel's bins == sort epilogue == plain
        flat = bins_k.permute(1, 0, 2).reshape(q, b).contiguous()
        ev, ei = K._extract_topk(flat, k, kpad)
        pv, pi = R.extract_topk(flat, k, kpad)
        sv, si = K._topk_bins(flat, k, epilogue="sort")
        sync()
        assert torch.equal(ev, pv) and torch.equal(ei, pi), "extract vs plain"
        assert torch.equal(ev[:, :k], sv) and torch.equal(
            ei[:, :k].long(), si), "extract vs sort epilogue"
        log(f"[kernels] extract Q={q}: identical to plain and to sort")

        # -- times (device, CUDA events)
        t = {}
        t["bf16"] = cuda_ms(lambda: K.streaming_bins(qt, dev, valid, tile, rows), reps)
        t["bf16_plain"] = cuda_ms(lambda: R.streaming_bins_bf16(
            qt, dev, valid, tile, rows, tile_bits), max(1, reps // 3))
        t["bf16_lib"] = cuda_ms(lambda: torch.topk(
            qt.to(torch.bfloat16) @ dev.to(torch.bfloat16).T, k, dim=1), max(1, reps // 3))
        t["i8"] = cuda_ms(lambda: K.streaming_bins_int8(
            q_i8, c_i8, c_scale, valid, tile, rows), reps)
        t["i8_plain"] = cuda_ms(lambda: R.streaming_bins_int8(
            q_i8, c_i8, c_scale, valid, tile, rows, tile_bits), max(1, reps // 3))
        t["i8_lib"] = cuda_ms(lambda: torch.topk(
            q_i8.to(torch.bfloat16) @ c_i8.to(torch.bfloat16).T, k, dim=1), max(1, reps // 3))
        # the s8 product alone (cuBLASLt, no top-k; a (Q, N) int32 output),
        # which takes more than 16 rows: Q = 16 runs as 32
        q_mm = q_i8 if q > 16 else torch.cat([q_i8, q_i8])
        t["i8_int_mm"] = cuda_ms(lambda: torch._int_mm(q_mm, c_i8.T), max(1, reps // 3))
        # #4 and its yardsticks take microseconds: the time of a call, and
        # beside it the device's time from CUDA graphs
        ex = (lambda: K._extract_topk(flat, k, kpad))
        lib = (lambda: torch.topk(flat, k, dim=1))
        # the sort epilogue every full-scan search runs, over the same bins
        srt = (lambda: K.topk_lowest_index(flat, k))
        t["ex"] = cuda_ms(ex, reps * 20)
        t["ex_device"] = graph_ms(ex, reps * 4)
        t["ex_plain"] = cuda_ms(lambda: R.extract_topk(flat, k, kpad), max(1, reps // 3))
        t["ex_lib"] = cuda_ms(lib, reps * 20)
        t["ex_lib_device"] = graph_ms(lib, reps * 4)
        t["ex_sort"] = cuda_ms(srt, reps * 20)
        t["ex_sort_device"] = graph_ms(srt, reps * 4)
        log(f"[kernels] Q={q} ms: " + " ".join(f"{a}={v:.4f}" for a, v in t.items()))

        out_bytes = rows * q * tile * 4
        b2 = bound_ms(n * d * 4 + q * d * 4 + n + out_bytes, 2 * q * n * d, H100_BF16_OPS)
        b3 = bound_ms(n * d + q * d + n * 4 + n + out_bytes, 2 * q * n * d, H100_INT8_OPS)
        # #4 is a top-k of B values a row: one read of the bins, one write
        # of kpad values and ids, and B compares a row outside the tensor cores
        b4 = bound_ms(q * b * 4 + 2 * q * kpad * 4, q * b, H100_FP32_OPS)
        sms = torch.cuda.get_device_properties(dev.device).multi_processor_count
        plan = K._streaming_plan(
            q, d, dev.dtype, dev.data_ptr(), n_tiles, rows, tile, sms)
        plan8 = K._int8_plan(q, d, q_i8.data_ptr(), c_i8.data_ptr(), n_tiles,
                             rows, tile, sms)
        log(f"[kernels] bf16 Q={q}: a call {t['bf16']:.4f}ms, "
            f"torch.topk(bf16 matmul) {t['bf16_lib']:.4f}ms; bound "
            f"{b2[0]:.4f}ms ({b2[1]}), {b2[0] / t['bf16']:.4f} of it; achieved "
            f"{2 * q * n * d / t['bf16'] / 1e9:.2f} TFLOP/s; plan nq={plan.nq} "
            f"query blocks={plan.qblocks} cluster={plan.cluster} "
            f"splits={plan.splits} stages={plan.stages} smem={plan.smem}; "
            f"first version "
            f"{FIRST_VERSION_MS['streaming_topk_bf16'][q]}ms a call (copied "
            f"from PERF.md, not measured here)")
        log(f"[kernels] int8 Q={q}: a call {t['i8']:.4f}ms, "
            f"torch.topk(bf16 matmul) {t['i8_lib']:.4f}ms, torch._int_mm (the s8 "
            f"product alone, {q_mm.shape[0]} rows) {t['i8_int_mm']:.4f}ms; bound "
            f"{b3[0]:.4f}ms ({b3[1]}), {b3[0] / t['i8']:.4f} of it; achieved "
            f"{2 * q * n * d / t['i8'] / 1e9:.2f} TOP/s; plan nq={plan8.nq} "
            f"query blocks={plan8.qblocks} cluster={plan8.cluster} "
            f"splits={plan8.splits} stages={plan8.stages} smem={plan8.smem} "
            f"queries kept={plan8.q_kept}; first version "
            f"{FIRST_VERSION_MS['streaming_topk_int8'][q]}ms a call (copied "
            f"from PERF.md, not measured here)")
        log(f"[kernels] extract Q={q}: a call {t['ex']:.4f}ms, torch.topk's "
            f"{t['ex_lib']:.4f}ms, the sort epilogue's (topk_lowest_index) "
            f"{t['ex_sort']:.4f}ms; on the device {t['ex_device']:.4f}ms, "
            f"{t['ex_lib_device']:.4f}ms, {t['ex_sort_device']:.4f}ms; bound "
            f"{b4[0]:.6f}ms ({b4[1]}), {b4[0] / t['ex']:.4f} of it a call, "
            f"{b4[0] / t['ex_device']:.4f} on the device; first version "
            f"{FIRST_VERSION_MS['extract_topk'][q]}ms a call (copied from "
            f"PERF.md, not measured here)")
        base = "nornicdb_tpu_torch/ops/csrc/"
        entries += [
            dict(name=f"streaming_topk_bf16[Q={q}]", route="cuda",
                 source=base + "streaming_topk_bf16.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:140",
                 counter="streaming_topk_bf16", max_abs_err=err2,
                 ms=t["bf16"], plain_ms=t["bf16_plain"], bound_ms=b2[0],
                 bound_by=b2[1], library_ms=t["bf16_lib"]),
            dict(name=f"streaming_topk_int8[Q={q}]", route="cuda",
                 source=base + "streaming_topk.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:244",
                 counter="streaming_topk_int8", max_abs_err=0.0,
                 ms=t["i8"], plain_ms=t["i8_plain"], bound_ms=b3[0],
                 bound_by=b3[1], library_ms=t["i8_lib"]),
            dict(name=f"extract_topk[Q={q}]", route="cuda",
                 source=base + "extract_topk.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:275",
                 counter="extract_topk", max_abs_err=0.0,
                 ms=t["ex"], plain_ms=t["ex_plain"], bound_ms=b4[0],
                 bound_by=b4[1], library_ms=t["ex_lib"],
                 device_ms=t["ex_device"], library_device_ms=t["ex_lib_device"]),
        ]
        del bins_k, bins_p, bins8_k, bins8_p, flat
        torch.cuda.empty_cache()
    return entries


def phase_int8_10m(K, R, seed: int, k: int, reps: int) -> None:
    """Kernel #3 at BASELINE.json's headline scale: N_10M x 1024 int8 codes
    made on the card from ``seed`` (10.24 GB; positive scales, 1% of rows
    masked; the bin geometry of pick_tile_n and streaming_rows_for(k, .)).
    The bins are bit-identical to the plain version's at Q = 16; the time
    of a call at Q = 16 and 1024 is logged beside its bounds. A kernel time,
    not a service latency: no load, no batching, no result epilogue."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d = N_10M, DIMS
    t0 = time.perf_counter()
    c_i8 = torch.empty((n, d), dtype=torch.int8, device=dev).random_(
        -127, 128, generator=gen)
    c_scale = torch.rand(n, generator=gen, device=dev) * 1000 + 600
    valid = torch.rand(n, generator=gen, device=dev) >= 0.01
    q_all = torch.empty((1024, d), dtype=torch.int8, device=dev).random_(
        -127, 128, generator=gen)
    sync()
    tile = K.pick_tile_n(n)
    rows = min(K.streaming_rows_for(k, tile), n // tile)
    n_tiles, rows, tile_bits = K.streaming_geometry(n, tile, rows)
    log(f"[int8-10M] N={n} D={d} codes made on the card in "
        f"{time.perf_counter() - t0:.1f}s; tile_n={tile} rows={rows} "
        f"tile_bits={tile_bits} masked rows={int((~valid).sum())}")
    for q in (16, 1024):
        qt = q_all[:q].contiguous()
        if q == 16:
            got = K.streaming_bins_int8(qt, c_i8, c_scale, valid, tile, rows)
            want = R.streaming_bins_int8(qt, c_i8, c_scale, valid, tile, rows,
                                         tile_bits)
            sync()
            assert torch.equal(got, want), (
                "10M int8 bins differ", int((got != want).sum()))
            log(f"[int8-10M] Q={q}: bins bit-identical to the plain version")
            del got, want
        ms = cuda_ms(lambda: K.streaming_bins_int8(
            qt, c_i8, c_scale, valid, tile, rows), reps)
        out_bytes = rows * q * tile * 4
        nbytes = n * d + q * d + n * 4 + n + out_bytes
        b = bound_ms(nbytes, 2 * q * n * d, H100_INT8_OPS)
        log(f"[int8-10M] Q={q}: a call {ms:.4f}ms (a kernel time, not a "
            f"service latency); bytes bound {nbytes / H100_BYTES * 1e3:.4f}ms, "
            f"operations bound {2 * q * n * d / H100_INT8_OPS * 1e3:.4f}ms, "
            f"{b[0] / ms:.4f} of the larger ({b[1]})")
    del c_i8, c_scale, valid, q_all
    torch.cuda.empty_cache()


def drive_service(svc, queries: np.ndarray, k: int, writes) -> dict:
    """32 client threads x (len(queries) / 32) sequential vector_candidates
    calls; `writes()` runs on this thread meanwhile."""
    n_threads = 32
    per = len(queries) // n_threads
    results: list = [None] * len(queries)
    start = np.zeros(len(queries))
    lat = np.zeros(len(queries))
    errors: list = []

    def client(t: int) -> None:
        try:
            for j in range(per):
                i = t * per + j
                start[i] = time.perf_counter()
                results[i] = svc.vector_candidates(queries[i], k=k)
                lat[i] = time.perf_counter() - start[i]
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    writes()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(results=results, wall=wall, lat=lat, start=start - t0, t0=t0)


def log_timeline(run: dict, batch_log: list, out_dir: str) -> None:
    """Where the service's slow queries spent their time: each fused
    batch's start, duration and size, the gaps between batches, and the
    slowest queries' submit times, all in ms from the first client start.
    The full timeline goes to ``chiprun_out/phase2_timeline.json``."""
    t0 = run["t0"]
    batches = [((a - t0) * 1e3, (b - a) * 1e3, n) for a, b, n in batch_log]
    gaps = [(batch_log[i + 1][0] - batch_log[i][1]) * 1e3
            for i in range(len(batch_log) - 1)]
    slow = np.argsort(-run["lat"])[:4]
    queries = [(float(run["start"][i] * 1e3), float(run["lat"][i] * 1e3))
               for i in range(len(run["lat"]))]
    with open(os.path.join(out_dir, "phase2_timeline.json"), "w") as f:
        json.dump({"batches_start_ms_dur_ms_size": batches,
                   "queries_start_ms_latency_ms": queries}, f)
    log("[phase2] timeline (ms from first client start): batches "
        + " ".join(f"{s:.1f}+{d:.1f}({n})" for s, d, n in batches)
        + f"; gaps sum {sum(gaps):.1f} max {max(gaps, default=0.0):.1f}"
        + "; slowest queries (start, latency): "
        + " ".join(f"({queries[i][0]:.1f}, {queries[i][1]:.1f})" for i in slow))


def profile_search(corpus, queries: np.ndarray, k: int, batch: int,
                   out_dir: str) -> None:
    """Device busy share of sequential fused batches through
    ``DeviceCorpus.search`` (the batcher's dispatch), from torch.profiler:
    the device time of every kernel over the host wall time of the window.
    The per-op table goes to ``chiprun_out/profile_search.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [queries[i:i + batch] for i in range(0, len(queries), batch)]
    for b in batches[:3]:
        corpus.search(b, k=k)  # warm: lazily loaded kernels, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            corpus.search(b, k=k)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    with open(os.path.join(out_dir, "profile_search.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=25))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=25))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {len(batches)} batches of {batch}: wall {wall * 1e3:.2f}ms "
        f"device {dev_us / 1e3:.2f}ms busy share "
        f"{dev_us / 1e6 / wall:.4f} per batch {wall * 1e3 / len(batches):.3f}ms; top device ops: "
        + "; ".join(f"{e.key[:60]}={e.self_device_time_total / 1e3:.3f}ms"
                    for e in top))


def build_gen_requests(n: int, seed: int, vocab: int) -> list:
    """scripts/bench_generate.py's request set: the first two are rag (one
    registers the shared prefix, the next hits it); one fixed shared prefix
    per kind."""
    rng = np.random.default_rng(seed)
    weights = np.array([m[3] for m in GEN_MIX])
    kinds = rng.choice(len(GEN_MIX), size=n, p=weights / weights.sum())
    kinds[: min(2, n)] = len(GEN_MIX) - 1
    prefixes = {ki: [int(x) for x in rng.integers(4, vocab, m[4])]
                for ki, m in enumerate(GEN_MIX)}
    out = []
    for i in range(n):
        _, plen, max_new, _, pfx = GEN_MIX[kinds[i]]
        suffix = [int(x) for x in rng.integers(4, vocab, plen - pfx)]
        out.append((prefixes[kinds[i]] + suffix, max_new))
    return out


def probe_attention_inputs(Q, K, params, cfg, gcfg, rng):
    """The ragged kernel's inputs in layer 0 of one real fused step: eight
    decode lanes at mixed lengths (prefilled through ``paged_prefill_chunk``),
    a 50-token chunk (Tq = 64, 14 padding rows) behind a page it shares with
    the last decode lane, and 6 padding rows in the flat batch. Also the
    largest difference between the step's decode-row logits and the dense
    path's (``prefill`` + ``decode_step``) for the same tokens
    (``logit_diff``)."""
    import torch

    dev = params["tok_emb"].device
    ps = gcfg.page_size
    w = Q.pages_for(gcfg.max_seq_tokens, ps)
    lmax = gcfg.max_seqs + 2
    pool = Q.init_kv_pages(cfg, gcfg.pool_pages, ps, dev)
    tables = np.zeros((lmax, w), np.int32)
    free = list(range(gcfg.pool_pages - 1, 0, -1))
    lengths = [12, 27, 40, 63, 80, 110, 150, 200]
    prompts, nxt = [], []
    for i, n in enumerate(lengths):
        prompt = [int(x) for x in rng.integers(4, cfg.vocab_size, n)]
        tables[i, :Q.pages_for(n + 1, ps)] = [
            free.pop() for _ in range(Q.pages_for(n + 1, ps))]
        table = torch.from_numpy(tables[i]).to(dev)
        for a in range(0, n, 64):
            piece = prompt[a:a + 64]
            ids = torch.tensor(piece + [0] * (64 - len(piece)), device=dev)
            logits, pool = Q.paged_prefill_chunk(params, cfg, ids, pool, table,
                                                 a, len(piece))
        prompts.append(prompt)
        nxt.append(int(torch.argmax(logits)))
    chunk_lane, n_valid, tq = lmax - 2, 50, 64
    # the chunk sequence shares the last decode lane's first (full) page
    chunk_prompt = prompts[-1][:ps] + [
        int(x) for x in rng.integers(4, cfg.vocab_size, n_valid)]
    tables[chunk_lane, 0] = tables[len(lengths) - 1, 0]
    own = Q.pages_for(len(chunk_prompt) + 1, ps) - 1
    tables[chunk_lane, 1:1 + own] = [free.pop() for _ in range(own)]
    ndec = len(lengths)
    f = Q.round_up_pow2(ndec + n_valid, 8)
    meta, (tokens, lane_id, lane_pos, positions, logit_rows,
           lane_tables) = Q.pack_ragged_meta(lmax, w, f)
    tokens[:], lane_id[:], lane_pos[:], positions[:] = 0, lmax - 1, 0, -1
    logit_rows[:] = 0
    lane_tables[:] = tables
    for i in range(ndec):
        tokens[i], lane_id[i], positions[i], logit_rows[i] = (
            nxt[i], i, lengths[i], i)
    for j in range(n_valid):
        fi = ndec + j
        tokens[fi], lane_id[fi] = chunk_prompt[ps + j], chunk_lane
        lane_pos[fi], positions[fi] = j, ps + j
    logit_rows[ndec] = ndec + n_valid - 1
    captured = {}
    real = K.ragged_paged_attention

    def record(*a):
        key = "decode" if a[0].shape[1] == 1 else "chunk"
        if key not in captured:
            captured[key] = tuple(t.clone() for t in a)
        return real(*a)

    K.ragged_paged_attention = record
    try:
        _, logits, _ = Q.ragged_fused_step(
            params, cfg, torch.from_numpy(meta).to(dev), pool, lmax=lmax,
            w=w, tq=tq, attn_impl="cuda")
    finally:
        K.ragged_paged_attention = real
    # the decode rows' logits beside what the dense path gives each lane
    width = w * ps
    diffs = []
    for i, prompt in enumerate(prompts):
        _, caches = Q.prefill(params, cfg, torch.tensor([prompt], device=dev),
                              width)
        ref, _ = Q.decode_step(params, cfg, torch.tensor([nxt[i]], device=dev),
                               caches, len(prompt))
        diffs.append(float((ref[0] - logits[i]).abs().max()))
    captured["logit_diff"] = max(diffs)
    return captured


def attention_library(q, k_pages, v_pages, tables, positions):
    """One gather of each lane's pages plus PyTorch's fused attention: the
    yardstick of the ragged kernel (timed only)."""
    import torch
    import torch.nn.functional as F

    l, tq, h, dh = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    s = tables.shape[1] * ps
    idx = tables.long()
    k = k_pages[idx].reshape(l, s, hkv, dh).transpose(1, 2)
    v = v_pages[idx].reshape(l, s, hkv, dh).transpose(1, 2)
    visible = torch.arange(s, device=q.device) <= positions[..., None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=visible[:, None], enable_gqa=True)


def phase_attention(K, R, captured, logit_diffs, reps):
    """The ragged kernel against its plain version on a real step's inputs,
    its time, the plain and library times, and its bound: the bytes of the
    valid q rows, the output, the tables and positions, and the K/V pages
    each lane needs (slots up to its largest position), at 3.35 TB/s."""
    import torch

    entries = []
    log(f"[phase5] fused step vs dense path, decode rows, {len(logit_diffs)} "
        f"probes: max|dlogit|=" + " ".join(f"{d:.4g}" for d in logit_diffs)
        + f" (at most {GEN_MARGIN_TOL / 2})")
    assert max(logit_diffs) <= GEN_MARGIN_TOL / 2, (
        "fused step logits vs dense path", logit_diffs)
    for key in ("decode", "chunk"):
        a = captured[key]
        q, k_pages, v_pages, tables, positions = a
        l, tq, h, dh = q.shape
        ps, hkv = k_pages.shape[1], k_pages.shape[2]
        got = K.ragged_paged_attention(*a)
        want = R.ragged_paged_attention(*a)
        sync()
        err = float((got.float() - want.float()).abs().max())
        tol_ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), rtol=ATTN_TOL_BF16, atol=ATTN_TOL_BF16)
        pos = positions.cpu().numpy()
        lane_max = pos.max(axis=1)
        pages = int(sum(-(-(m + 1) // ps) for m in lane_max if m >= 0))
        esize = q.element_size()
        # q of the valid rows only (a padding row's query is never needed),
        # the whole output, tables, positions and the pages the lanes need;
        # both products take operands of q's type, summed in float32
        rows = int((pos >= 0).sum())
        nbytes = ((rows * h * dh + q.numel()) * esize + tables.numel() * 4
                  + pos.size * 4 + 2 * pages * ps * hkv * dh * esize)
        ops = 4 * h * dh * int((pos[pos >= 0] + 1).sum())
        bound = bound_ms(nbytes, ops, H100_BF16_OPS
                         if q.dtype == torch.bfloat16 else H100_FP32_OPS)
        # a call takes tens of microseconds: its time (the median of five
        # runs), and beside it the device's time from CUDA graphs
        kern = (lambda: K.ragged_paged_attention(*a))
        lib = (lambda: attention_library(*a))
        t = {"ms": call_ms(kern, reps * 20),
             "device": graph_ms(kern, reps * 4),
             "plain": call_ms(lambda: R.ragged_paged_attention(*a), reps * 20),
             "lib": call_ms(lib, reps * 20),
             "lib_device": graph_ms(lib, reps * 4)}
        plan = K._ragged_plan(l, tq, h, hkv, dh, k_pages.shape[0], ps,
                              tables.shape[1], q.dtype)
        log(f"[phase5] ragged {key}: L={l} Tq={tq} H={h} Hkv={hkv} Dh={dh} "
            f"P={tables.shape[1]} valid rows={rows} "
            f"pages read={pages} max|d|={err:.3g} (tol {ATTN_TOL_BF16:.3g}) "
            f"ms={t['ms']:.4f} device={t['device']:.4f} plain={t['plain']:.4f} "
            f"lib={t['lib']:.4f} lib device={t['lib_device']:.4f} "
            f"bound={bound[0]:.5f} ({bound[1]}); plan qb={plan.qb} "
            f"cluster={plan.cluster} smem={plan.smem}; CTAs a lane "
            + str([K._ragged_split(int(m), tables.shape[1] * ps) for m in lane_max])
            + f"; first version "
            f"{FIRST_VERSION_MS['ragged_paged_attention'][key]}ms a call "
            f"(copied from PERF.md, not measured here)")
        assert tol_ok, ("ragged kernel vs plain", key, err)
        entries.append(dict(
            name=f"ragged_paged_attention[{key} L={l} Tq={tq}]", route="cuda",
            source="nornicdb_tpu_torch/ops/csrc/ragged_paged_attention.cu",
            replaces="nornicdb_tpu/ops/pallas_kernels.py:446",
            counter="ragged_paged_attention", max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain"], bound_ms=bound[0], bound_by=bound[1],
            library_ms=t["lib"], device_ms=t["device"],
            library_device_ms=t["lib_device"]))
    return entries


def drive_engine(eng, requests: list, n_threads: int, retry=None) -> dict:
    """n_threads closed-loop clients, request i on thread i % n_threads:
    submit (through ``retry``, a _Backoff, when given: the cost model may
    shed a submit it predicts past the deadline), stream every token (time
    to first token, gaps between tokens, the whole request), next
    request."""
    n = len(requests)
    outs: list = [None] * n
    ttft = np.zeros(n)
    lat = np.zeros(n)
    gaps: list = []
    errors: list = []
    lock = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t, n, n_threads):
                prompt, max_new = requests[i]
                t0 = time.perf_counter()
                h = (retry(eng.submit, prompt, max_new_tokens=max_new)
                     if retry else eng.submit(prompt, max_new_tokens=max_new))
                last, mine = None, []
                for _ in h.stream_tokens():
                    now = time.perf_counter()
                    if last is None:
                        ttft[i] = now - t0
                    else:
                        mine.append(now - last)
                    last = now
                outs[i] = h.result()
                lat[i] = time.perf_counter() - t0
                with lock:
                    gaps.extend(mine)
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(outs=outs, ttft=ttft, gaps=np.asarray(gaps), lat=lat,
                wall=wall)


def dense_agreement(Q, params, cfg, prompt, gen, max_new, eos, max_len):
    """Check every greedy token of ``gen`` against the dense plain
    reference (prefill + decode_step at the engine's cache width, fed the
    engine's own tokens): the token's reference logit must lie within
    GEN_MARGIN_TOL of the reference's largest, so only a near-tie may pick
    another token. Returns (tokens equal to the reference's argmax, the
    largest shortfall of a chosen token's logit)."""
    import torch

    dev = params["tok_emb"].device
    logits, caches = Q.prefill(
        params, cfg, torch.tensor([prompt], device=dev), max_len)
    pos = len(prompt)
    equal, worst = 0, 0.0
    for j, tok in enumerate(gen):
        row = logits[0]
        ref = int(torch.argmax(row))
        short = float(row[ref] - row[tok])
        assert short <= GEN_MARGIN_TOL, (
            "engine's token is no near-tie of the dense reference's",
            j, tok, ref, short)
        equal += tok == ref
        worst = max(worst, short)
        if j + 1 < len(gen):
            logits, caches = Q.decode_step(
                params, cfg, torch.tensor([tok], device=dev), caches, pos)
            pos += 1
    assert gen[-1] == eos or len(gen) == max_new, ("stopped early", len(gen))
    return equal, worst


def profile_generation(eng, requests: list, out_dir: str) -> None:
    """Device busy share of the engine serving ``requests`` (all submitted
    at once), from torch.profiler: the device time of every kernel over the
    host wall time of the window, and kernels launched per fused step. The
    per-op table goes to ``chiprun_out/profile_generate.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = eng.stats.fused_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=m) for p, m in requests]
        for h in handles:
            h.result()
        wall = time.perf_counter() - t0
    steps = eng.stats.fused_steps - steps0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launched = sum(e.count for e in kernels)
    with open(os.path.join(out_dir, "profile_generate.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] generation: {len(requests)} requests, {steps} fused steps "
        f"in {wall * 1e3:.2f}ms ({wall * 1e3 / max(1, steps):.3f}ms a step); "
        f"device {dev_us / 1e3:.2f}ms busy share {dev_us / 1e6 / wall:.4f}; "
        f"{launched / max(1, steps):.1f} device ops a step; top device ops: "
        + "; ".join(f"{e.key[:50]}={e.self_device_time_total / 1e3:.3f}ms"
                    f"/{e.count}" for e in top))


def phase_generation(K, R, seed: int, profile_dir: str = "") -> tuple[list, dict]:
    """Phase 5: the ragged kernel on a real step, then the engine serving
    GEN_REQUESTS requests at full width, checked against the dense
    reference. With
    ``profile_dir``, then a torch.profiler window over 8 more requests."""
    import torch

    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.models import training as TT
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

    cfg = Q.QWEN25_05B
    gcfg = GenServeConfig()
    t0 = time.perf_counter()
    params = Q.with_f32_logit_weights(Q.init_params(cfg, seed, "cuda"))
    # every leaf of the tree, final_norm's included (the float32 copy of
    # the tied table is derived, not a parameter)
    n_params = sum(t.numel() for t in TT.param_leaves(params))
    sync()
    log(f"[phase5] QWEN25_05B bf16: {n_params} parameters in "
        f"{time.perf_counter() - t0:.1f}s")
    assert n_params == 494_032_768, n_params

    # -- 5a: the kernel on a real step's inputs; the fused step's logits
    # against the dense path's over GEN_PROBES prompt sets
    t0 = time.perf_counter()
    probes = [probe_attention_inputs(Q, K, params, cfg, gcfg,
                                     np.random.default_rng(seed + i))
              for i in range(GEN_PROBES)]
    sync()
    entries = phase_attention(K, R, probes[0],
                              [p["logit_diff"] for p in probes], REPS)
    del probes
    log(f"[phase5] kernel vs plain: {time.perf_counter() - t0:.1f}s")

    # -- 5b: the engine
    tok = HashTokenizer(cfg.vocab_size)
    eng = GenerationEngine(params, cfg, tokenizer=tok, config=gcfg)
    t0 = time.perf_counter()
    K.reset_launch_counts()
    eng.warmup()
    sync()
    warm = K.launch_counts()["ragged_paged_attention"]
    classes = eng._ragged_classes()
    log(f"[phase5] warmup {len(classes)} classes in "
        f"{time.perf_counter() - t0:.1f}s, {warm} kernel launches")
    assert warm == cfg.layers * sum(1 + (tq > 1) for _, tq in classes)
    requests = build_gen_requests(GEN_REQUESTS, seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    retry = _Backoff()
    run = drive_engine(eng, requests, GEN_CLIENTS, retry)
    launches = K.launch_counts()["ragged_paged_attention"]
    st = dataclasses.replace(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    if profile_dir:
        profile_generation(eng, requests[:GEN_CLIENTS], profile_dir)
    eng.stop()
    GEN_COUNTED["5b"] = eng.stats.generated_tokens
    PREDICTED_SHEDS["5b"] = (eng.stats.sheds_predicted, retry.sheds)
    tokens = sum(len(o) for o in run["outs"])
    paged = serve_summary(run)
    log(f"[phase5] {GEN_REQUESTS} requests from {GEN_CLIENTS} clients: "
        f"{tokens} tokens in {run['wall']:.3f}s tok/s={paged['tok_s']:.1f} "
        f"ttft p50={paged['ttft_p50']:.2f}ms "
        f"p99={np.percentile(run['ttft'], 99) * 1e3:.2f}ms "
        f"per-token p50={paged['gap_p50']:.2f}ms "
        f"fused steps={st.fused_steps} chunk steps={st.prefill_chunks} "
        f"mean decode lanes={st.decode_lane_tokens / max(1, st.decode_steps):.2f} "
        f"prefix hits={st.prefix_hits} reused tokens={st.prefix_reused_tokens} "
        f"launches={launches} max_memory_allocated={peak / 2**30:.3f}GiB "
        f"({held / 2**30:.3f}GiB held before the run) predicted-deadline "
        f"sheds={st.sheds_predicted} ({retry.sheds} submits retried) "
        f"stats={st.as_dict()}")
    assert st.completed == GEN_REQUESTS and all(
        o for o in run["outs"]), ("requests not completed", st.as_dict())
    assert st.prefix_hits > 0, "the prefix cache never hit"
    assert launches > 0 and launches == cfg.layers * (
        st.fused_steps + st.prefill_chunks), (
        "ragged launches", launches, st.fused_steps, st.prefill_chunks)

    # -- 5c: greedy tokens against the dense plain reference
    t0 = time.perf_counter()
    width = Q.pages_for(gcfg.max_seq_tokens, gcfg.page_size) * gcfg.page_size
    equal = full = 0
    worst = 0.0
    for (prompt, max_new), gen in zip(requests, run["outs"]):
        same, short = dense_agreement(Q, params, cfg, prompt, gen, max_new,
                                      tok.eos_id, width)
        equal += same
        full += same == len(gen)
        worst = max(worst, short)
    log(f"[phase5] dense reference: all {tokens} tokens checked, {equal} "
        f"equal to its argmax, {full}/{GEN_REQUESTS} requests equal in full, "
        f"largest shortfall of a chosen token {worst:.4g} (at most "
        f"{GEN_MARGIN_TOL}) in {time.perf_counter() - t0:.1f}s")
    del eng

    t0 = time.perf_counter()
    phase_dense_mode(K, Q, params, cfg, gcfg, tok, requests, paged)
    log(f"[phase5d] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_sync_generation(Q, params, cfg, tok, seed)
    log(f"[phase5e] {time.perf_counter() - t0:.1f}s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return entries, {"ragged_paged_attention": launches}


def serve_summary(run: dict) -> dict:
    """tok/s over the run, ttft p50 and per-token p50 (ms) of a
    ``drive_engine`` run."""
    tokens = sum(len(o) for o in run["outs"])
    return {"tok_s": tokens / run["wall"],
            "ttft_p50": float(np.median(run["ttft"])) * 1e3,
            "gap_p50": float(np.median(run["gaps"])) * 1e3}


def phase_dense_mode(K, Q, params, cfg, gcfg, tok, requests, paged) -> None:
    """Phase 5d: the engine in ``mode="dense"`` (a dense cache a sequence,
    torch ops) serves the first DENSE_REQUESTS of phase 5's requests from
    GEN_CLIENTS clients. No ragged kernel launches; every token passes
    ``dense_agreement`` at the width the engine gave its cache. Its
    tok/s, ttft and per-token p50 are logged beside phase 5's paged run
    (GEN_REQUESTS requests), to read, not to compare as a claim."""
    import torch

    from nornicdb_tpu_torch.genserve import GenerationEngine

    dcfg = dataclasses.replace(gcfg, mode="dense")
    eng = GenerationEngine(params, cfg, tokenizer=tok, config=dcfg)
    eng.warmup()  # one tiny request
    sub = requests[:DENSE_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    st0 = dataclasses.replace(eng.stats)
    retry = _Backoff()
    run = drive_engine(eng, sub, GEN_CLIENTS, retry)
    launches = K.launch_counts()["ragged_paged_attention"]
    st = dataclasses.replace(eng.stats)
    programs = sorted(eng.programs)
    peak = torch.cuda.max_memory_allocated()
    eng.stop()
    GEN_COUNTED["5d"] = eng.stats.generated_tokens
    PREDICTED_SHEDS["5d"] = (eng.stats.sheds_predicted, retry.sheds)
    dense = serve_summary(run)
    tokens = sum(len(o) for o in run["outs"])
    log(f"[phase5d] dense mode, {len(sub)} requests from {GEN_CLIENTS} "
        f"clients: {tokens} tokens in {run['wall']:.3f}s "
        f"tok/s={dense['tok_s']:.1f} ttft p50={dense['ttft_p50']:.2f}ms "
        f"per-token p50={dense['gap_p50']:.2f}ms (phase 5 paged, "
        f"{GEN_REQUESTS} requests: tok/s={paged['tok_s']:.1f} ttft p50="
        f"{paged['ttft_p50']:.2f}ms per-token p50={paged['gap_p50']:.2f}ms); "
        f"prefills={st.prefill_chunks - st0.prefill_chunks} decode steps="
        f"{st.decode_steps - st0.decode_steps} "
        f"ragged launches={launches} longest request "
        f"{run['lat'].max():.3f}s (deadline {dcfg.deadline_ms / 1e3:g}s) "
        f"cache widths "
        f"{sorted({p[-1] for p in programs})} max_memory_allocated="
        f"{peak / 2**30:.3f}GiB; predicted-deadline sheds "
        f"{st.sheds_predicted} ({retry.sheds} submits retried)")
    assert st.completed - st0.completed == len(sub) and all(run["outs"]), (
        st.as_dict())
    assert launches == 0 and st.fused_steps == 0, ("dense mode ran the "
                                                   "ragged kernel", launches)
    equal = 0
    for (prompt, max_new), gen in zip(sub, run["outs"]):
        width = Q.round_up_pow2(min(len(prompt) + max_new,
                                    dcfg.max_seq_tokens))
        same, _ = dense_agreement(Q, params, cfg, prompt, gen, max_new,
                                  tok.eos_id, width)
        equal += same
    log(f"[phase5d] dense reference: all {tokens} tokens checked, {equal} "
        "equal to its argmax")


def phase_sync_generation(Q, params, cfg, tok, seed: int) -> None:
    """Phase 5e: Heimdall's synchronous ``QwenGenerator`` over phase 5's
    parameters on 4 text prompts. ``generate``'s text is ``qwen2.generate``'s
    tokens, which pass ``dense_agreement``; ``generate_stream``'s deltas
    join to that text; sampling at SYNC_TEMPERATURE repeats for one seed
    and moves for another; every id is below the vocabulary size."""
    from nornicdb_tpu_torch.heimdall import QwenGenerator
    from nornicdb_tpu_torch.heimdall.manager import _trim_prompt_ids

    gen = QwenGenerator(cfg=cfg, params=params, tokenizer=tok)
    rng = np.random.default_rng(seed + 5)
    prompts = [" ".join(rng.choice(EMBED_WORDS, size=n))
               for n in SYNC_PROMPT_WORDS]
    eos = tok.eos_id
    t_gen, t_stream, sampled, equal, n_tokens = [], [], {}, 0, 0
    for text in prompts:
        ids = _trim_prompt_ids(tok, text, gen.max_context)
        t0 = time.perf_counter()
        out = gen.generate(text, SYNC_NEW)
        t_gen.append(time.perf_counter() - t0)
        toks = Q.generate(gen.params, cfg, ids, SYNC_NEW, eos_id=eos)
        assert tok.decode(toks) == out, ("generate's text", text)
        # generate cuts the eos off; the reference check wants it back
        full = toks + ([eos] if len(toks) < SYNC_NEW else [])
        same, _ = dense_agreement(Q, gen.params, cfg, ids, full, SYNC_NEW,
                                  eos, len(ids) + SYNC_NEW)
        equal += same
        n_tokens += len(full)
        t0 = time.perf_counter()
        stream = list(gen.generate_stream(text, SYNC_NEW))
        t_stream.append(time.perf_counter() - t0)
        assert "".join(stream) == out, ("stream deltas", text)
        for s in (seed + 1, seed + 1, seed + 2):
            sampled.setdefault(s, []).append(Q.generate(
                gen.params, cfg, ids, SYNC_NEW, temperature=SYNC_TEMPERATURE,
                eos_id=eos, seed=s))
    one, again = sampled[seed + 1][0::2], sampled[seed + 1][1::2]
    other = sampled[seed + 2]
    changed = sum(a != b for a, b in zip(one, other))
    ids_ok = all(0 <= t < cfg.vocab_size for r in one + other for t in r)
    log(f"[phase5e] QwenGenerator, {len(prompts)} prompts of "
        f"{list(SYNC_PROMPT_WORDS)} words x {SYNC_NEW} tokens: generate "
        f"p50={np.median(t_gen) * 1e3:.1f}ms stream p50="
        f"{np.median(t_stream) * 1e3:.1f}ms ({SYNC_NEW / np.median(t_gen):.1f} "
        f"tok/s a request); dense reference: {n_tokens} tokens checked, "
        f"{equal} equal to its argmax; T={SYNC_TEMPERATURE}: seed {seed + 1} "
        f"twice identical {one == again}, seed {seed + 2} changed {changed}/"
        f"{len(prompts)} outputs")
    assert one == again, "sampling is not deterministic for one seed"
    assert changed >= 1, "another seed changed no output"
    assert ids_ok, "a sampled id is outside the vocabulary"


def phase_fused_cosine(K, R, dev, valid, qs_all, k, reps):
    """Phase 6: kernel #1 on the main path (``ops.fused_cosine_topk`` at
    Q = 1024 and Q = 16, tile_n 128: 1,000,064 rows are no multiple of 512),
    then against its plain version and timed. Returns (entries, launches)."""
    import torch
    import torch.nn.functional as F

    from nornicdb_tpu_torch import ops
    from nornicdb_tpu_torch.ops import _build

    n, d = dev.shape
    log(f"[phase6] device memory allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.3f}GiB (this corpus buffer "
        f"{dev.numel() * dev.element_size() / 2**30:.3f}GiB)")
    for line in ptxas_summary(_build.ptxas_reports.get("fused_cosine", "")):
        log(f"[phase6] fused_cosine ptxas: {line}")
    qts = {q: torch.from_numpy(qs_all[:q]).to(dev.device) for q in (1024, 16)}
    K.reset_launch_counts()
    served = {q: ops.fused_cosine_topk(qt, dev, valid, k, tile_n=128)
              for q, qt in qts.items()}
    sync()
    launches = K.launch_counts()["fused_cosine_scores"]
    assert launches == len(qts), ("fused cosine launches", launches)
    entries = []
    for q, qt in qts.items():
        got = K.fused_cosine_scores(qt, dev, tile_n=128)
        want = R.fused_cosine_scores(qt, dev)
        sync()
        err = float((got - want).abs().max())
        del got
        masked = torch.where(valid[None, :], want, float("-inf"))
        del want
        _, pi = K.topk_lowest_index(masked, k)
        vk, ik = served[q]
        same = float((ik == pi).float().mean())
        # an id may differ only where two scores lie within the tolerance
        rr, jj = torch.nonzero(ik != pi, as_tuple=True)
        gap = float((masked[rr, ik[rr, jj]] - masked[rr, pi[rr, jj]]).abs().max()
                    ) if rr.numel() else 0.0
        del masked
        t = {"ms": cuda_ms(lambda: K.fused_cosine_scores(qt, dev, tile_n=128),
                           reps),
             "plain": cuda_ms(lambda: R.fused_cosine_scores(qt, dev),
                              max(1, reps // 3)),
             "lib": cuda_ms(lambda: torch.matmul(
                 qt, F.normalize(dev, dim=1).T), max(1, reps // 3))}
        ops_n = 2 * q * n * d + 3 * n * d
        b = bound_ms(n * d * 4 + q * d * 4 + q * n * 4, ops_n, H100_FP32_OPS)
        log(f"[phase6] fused cosine Q={q} N={n} D={d}: max|d|={err:.3g} (tol "
            f"{COSINE_TOL}) top-{k} ids equal to plain {same:.6f}, largest "
            f"score gap of a swapped id {gap:.3g}; ms={t['ms']:.4f} "
            f"plain={t['plain']:.4f} lib={t['lib']:.4f} bound={b[0]:.4f} "
            f"({b[1]}), {b[0] / t['ms']:.4f} of it; achieved "
            f"{ops_n / t['ms'] / 1e9:.2f} TFLOP/s; first version "
            f"{FIRST_VERSION_MS['fused_cosine_scores'][q]}ms (copied from "
            f"PERF.md, not measured here)")
        assert err <= COSINE_TOL, ("fused cosine kernel vs plain", q, err)
        assert gap <= COSINE_TOL, ("fused cosine top-k swap", q, gap)
        entries.append(dict(
            name=f"fused_cosine_scores[Q={q}]", route="cuda",
            source="nornicdb_tpu_torch/ops/csrc/fused_cosine.cu",
            replaces="nornicdb_tpu/ops/pallas_kernels.py:36",
            counter="fused_cosine_scores", max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain"], bound_ms=b[0], bound_by=b[1],
            library_ms=t["lib"]))
        torch.cuda.empty_cache()
    del served
    torch.cuda.empty_cache()
    return entries, {"fused_cosine_scores": launches}


def _rss_gib() -> float:
    """This process's resident host memory now, GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("VmRSS not in /proc/self/status")


def phase_ivf(svc, corpus, qs_serve, k, phase2: dict):
    """Phase 7: recluster (fit, layout, tune) and IVF serving through the
    batcher with the tuned plan."""
    import torch

    from nornicdb_tpu_torch.ops import ivf as IV
    from nornicdb_tpu_torch.ops import kernels as K
    from nornicdb_tpu_torch.ops.kmeans import optimal_k
    from nornicdb_tpu_torch.search import service as SV

    # -- 7.1 recluster, its steps timed
    secs: dict = {"upload": 0.0}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return wrapped

    real = (SV.kmeans_fit, IV.build_ivf_layout, IV._scatter_rows)
    SV.kmeans_fit = timed("fit", SV.kmeans_fit)
    IV.build_ivf_layout = timed("layout", IV.build_ivf_layout)
    IV._scatter_rows = timed("upload", IV._scatter_rows)
    peak_rss = [_rss_gib()]
    rss0 = peak_rss[0]
    stop = threading.Event()

    def sample_rss() -> None:
        while not stop.wait(0.05):
            peak_rss[0] = max(peak_rss[0], _rss_gib())

    sampler = threading.Thread(target=sample_rss)
    sampler.start()
    t0 = time.perf_counter()
    try:
        svc.recluster()
    finally:
        stop.set()
        sampler.join()
        SV.kmeans_fit, IV.build_ivf_layout, IV._scatter_rows = real
    t_recluster = time.perf_counter() - t0
    layout = corpus._ivf
    state = svc._tune_state
    spilled = int((layout.residual_slots >= 0).sum())
    log(f"[phase7] recluster {t_recluster:.1f}s: fit {secs['fit']:.2f}s "
        f"(K={layout.k}, sample {svc.config.cluster_fit_sample}), layout build "
        f"{secs['layout']:.2f}s of which row upload {secs['upload']:.2f}s, "
        f"tune {state.tune_seconds:.2f}s; Cmax={layout.cmax} spilled rows="
        f"{spilled} layout device bytes={layout.device_bytes} "
        f"({layout.device_bytes / 2**30:.3f}GiB); host RSS {rss0:.2f}GiB before, "
        f"peak {peak_rss[0]:.2f}GiB during recluster, process peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}GiB")
    log(f"[phase7] tune: {json.dumps(state.as_dict())}")
    assert layout.k == optimal_k(len(corpus)), ("clusters", layout.k)
    assert state.outcome == "ok", ("tune outcome", state.as_dict())
    assert 0 < state.n_probe < layout.k, ("n_probe", state.n_probe)

    # -- 7.2 fused batches of 16 back to back: IVF beside the full scan, and
    # ivf_search alone (the search less its id resolution and filtering)
    batches = [qs_serve[i:i + 16] for i in range(0, 256, 16)]
    side = {}
    runs = (("full", lambda b: corpus.search(b, k=k)),
            ("ivf", lambda b: corpus.search(b, k=k, n_probe=state.n_probe)),
            ("ivf_search", lambda b: IV.ivf_search(layout, b, k,
                                                   state.n_probe)),
            ("ivf2", lambda b: corpus.search(b, k=k, n_probe=state.n_probe)),
            ("full2", lambda b: corpus.search(b, k=k)))
    for name, fn in runs:
        fn(batches[0])
        t0 = time.perf_counter()
        for b in batches:
            fn(b)
        side[name] = (time.perf_counter() - t0) * 1e3 / len(batches)
    log("[phase7] sequential batches of 16, ms a batch: "
        + " ".join(f"{a}={v:.3f}" for a, v in side.items()))

    # -- 7.3 the service with the tuned plan
    batch_log: list = []
    inner = svc._batched_corpus_search

    def timed_batch(queries, kk, min_sim):
        t = time.perf_counter()
        try:
            return inner(queries, kk, min_sim)
        finally:
            batch_log.append((t, time.perf_counter(), len(queries)))

    svc._batched_corpus_search = timed_batch
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    run = drive_service(svc, qs_serve, k, lambda: None)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dispatches = corpus.sync_stats.device_dispatches - d0
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve, dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec = recall(run["results"], gt_ids)
    batch_ms = [(b - a) * 1e3 for a, b, _ in batch_log]
    sizes = [n for _, _, n in batch_log]
    log(f"[phase7] IVF n_probe={state.n_probe}: {len(qs_serve)} queries in "
        f"{run['wall']:.3f}s qps={len(qs_serve) / run['wall']:.1f} "
        f"(phase 2 full scan {phase2['qps']:.1f}) client "
        f"p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms (phase 2 "
        f"{phase2['p50']:.2f} / {phase2['p99']:.2f}) batch "
        f"p50={np.median(batch_ms):.2f}ms, {len(batch_log)} batches of mean "
        f"{np.mean(sizes):.1f} (max {max(sizes)}), dispatches={dispatches} "
        f"recall@{k}={rec:.4f} launches={counts} peak device memory "
        f"{peak / 2**30:.3f}GiB ({held / 2**30:.3f}GiB held before, a served "
        f"batch at most {(peak - held) / 2**30:.3f}GiB)")
    assert rec >= 0.95, ("IVF serving recall", rec)
    assert dispatches < len(qs_serve), ("no fusion", dispatches)
    # the pruned path served every batch: a full-scan fallback would have
    # launched the streaming kernel
    assert counts["streaming_topk_bf16"] == 0, ("full-scan fallback", counts)


def build_texts(n: int, seed: int) -> tuple[list, np.ndarray]:
    """scripts/bench_embed.py's corpus with a unique last word a text:
    (texts, kind index of each)."""
    rng = np.random.default_rng(seed)
    weights = np.array([m[1] for m in EMBED_MIX])
    kinds = rng.choice(len(EMBED_MIX), size=n, p=weights / weights.sum())
    texts = []
    for i in range(n):
        _, _, lo, hi = EMBED_MIX[kinds[i]]
        words = rng.choice(EMBED_WORDS, size=int(rng.integers(lo, hi + 1)))
        texts.append(" ".join(words) + f" n{i}")
    return texts, kinds


def drive_embed(eng, texts: list, n_threads: int, per_call: int,
                retry=None) -> dict:
    """n_threads closed-loop clients, each embedding its contiguous share
    of ``texts`` in calls of ``per_call``, as the EmbedWorker and HTTP
    /nornicdb/embed call ``embed_batch`` (through ``retry``, a _Backoff,
    when given: the cost model may shed a call it predicts past the
    deadline)."""
    share = len(texts) // n_threads
    out: list = [None] * len(texts)
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t * share, (t + 1) * share, per_call):
                t0 = time.perf_counter()
                batch = texts[i:i + per_call]
                out[i:i + per_call] = (retry(eng.embed_batch, batch) if retry
                                       else eng.embed_batch(batch))
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(out=out, lat=np.asarray(lat), wall=wall)


def profile_embed(eng, texts: list, out_dir: str) -> None:
    """Device busy share of the engine serving about 32 packs of the timed
    mix (16 clients x 2 calls of 64 texts), from torch.profiler: the device
    time of every kernel over the host wall time, device ops a pack, and
    the GEMM rows' share of device time (every product of the forward is
    float32: ``dense`` casts to float32 beside a bias, attention scores
    and P.V in float32). The per-op table goes to
    ``chiprun_out/profile_embed.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = EMBED_CLIENTS * 2 * EMBED_CALL
    packs0 = eng.stats.packed_batches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = drive_embed(eng, texts[:n], EMBED_CLIENTS, EMBED_CALL)
    packs = eng.stats.packed_batches - packs0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    gemm = [e for e in kernels if "gemm" in e.key.lower()]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    launched = sum(e.count for e in kernels)
    with open(os.path.join(out_dir, "profile_embed.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=30))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] embed: {n} texts in {packs} packs, wall "
        f"{run['wall'] * 1e3:.2f}ms ({run['wall'] * 1e3 / max(1, packs):.3f}ms "
        f"a pack); device {dev_us / 1e3:.2f}ms busy share "
        f"{dev_us / 1e6 / run['wall']:.4f}; {launched / max(1, packs):.1f} "
        f"device ops a pack; GEMM rows (float32) {gemm_us / 1e3:.2f}ms, "
        f"{gemm_us / max(dev_us, 1e-9):.4f} of device time over "
        f"{sum(e.count for e in gemm)} calls; top device ops: "
        + "; ".join(f"{e.key[:50]}={e.self_device_time_total / 1e3:.3f}ms"
                    f"/{e.count}" for e in top))


def phase_embed(K, seed: int, k: int, profile_dir: str = "") -> dict:
    """Phase 8: bge-m3 at full width and depth behind ServingEngine
    (ServingConfig defaults) embeds EMBED_TEXTS texts from EMBED_CLIENTS
    clients, checked against the padded per-request path; then a
    SearchService over the embeddings serves EMBED_QUERIES stored texts
    embedded again. Returns what phases 10 and 9 serve from: the texts,
    their embeddings and the embed engine, still running."""
    import torch

    from nornicdb_tpu_torch._device import map_tree
    from nornicdb_tpu_torch.config import ServingConfig
    from nornicdb_tpu_torch.embed import DeviceEmbedder
    from nornicdb_tpu_torch.models import bge_m3 as B
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer
    from nornicdb_tpu_torch.ops import similarity as S
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.serving import ServingEngine

    cfg = B.BGE_M3
    t0 = time.perf_counter()
    params = B.init_params(cfg, seed, "cuda")
    leaves: list = []
    map_tree(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    sync()
    log(f"[phase8] BGE_M3 bf16: {n_params} parameters "
        f"({n_params * 2 / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f}s")
    tok = HashTokenizer(cfg.vocab_size)
    emb = DeviceEmbedder(cfg=cfg, params=params, tokenizer=tok, max_len=512,
                         device="cuda")
    eng = ServingEngine(emb, ServingConfig())
    t0 = time.perf_counter()
    texts, kinds = build_texts(EMBED_TEXTS, seed)
    log(f"[phase8] {EMBED_TEXTS} texts in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{m[0]} {int((kinds == i).sum())}"
                    for i, m in enumerate(EMBED_MIX)))

    # every pack of the engine, timed: wall (the forward ends in a copy to
    # the host, so a sync) and device span (CUDA events around it)
    pack_log: list = []
    packed = emb.embed_packed

    def timed_packed(pack):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        ev0.record()
        out = packed(pack)
        ev1.record()
        ev1.synchronize()
        pack_log.append((time.perf_counter() - t, ev0.elapsed_time(ev1),
                         pack.shape_class, pack.n_segments, pack.tokens))
        return out

    emb.embed_packed = timed_packed

    # -- 8.1 warm each capacity class the mix reaches with one untimed full
    # pack (cuBLAS initialisation, allocator growth), outside the engine
    packer = eng._packer
    t0 = time.perf_counter()
    warmed = []
    for cap, kind in ((32, 0), (64, 2)):
        seqs = [tok.encode(texts[i], max_len=packer.max_len)
                for i in np.flatnonzero(kinds == kind)[:512]]
        take, _, _ = packer.plan([len(s) for s in seqs], budget_tokens=8192,
                                 capacity=cap)
        warm = packer.pack(seqs[:take], capacity=cap)  # as the engine packs
        packed(warm)
        warmed.append((*warm.ids.shape, take))
    sync()
    log(f"[phase8] warm packs (R, C, texts) {warmed} in "
        f"{time.perf_counter() - t0:.1f}s")
    assert {c for _, c, _ in warmed} == {32, 64}

    # -- 8.2 the timed window
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    retry = _Backoff()
    run = drive_embed(eng, texts, EMBED_CLIENTS, EMBED_CALL, retry)
    peak = torch.cuda.max_memory_allocated()
    snap = eng.stats_snapshot()
    st = dataclasses.replace(eng.stats)
    window = list(pack_log)
    embs = np.stack(run["out"])
    wall_ms = np.array([w for w, _, _, _, _ in window]) * 1e3
    span_ms = np.array([d for _, d, _, _, _ in window])
    classes = sorted({s for _, _, s, _, _ in window})
    log(f"[phase8] {EMBED_TEXTS} texts from {EMBED_CLIENTS} clients x "
        f"{EMBED_CALL} a call in {run['wall']:.3f}s: "
        f"embeddings/s={EMBED_TEXTS / run['wall']:.1f} "
        f"tokens/s={st.tokens / run['wall']:.1f} ({st.tokens} real tokens) "
        f"client p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms; "
        f"packs={st.packed_batches} texts a pack={st.texts / st.packed_batches:.2f} "
        f"pack p50 wall={np.median(wall_ms):.3f}ms device span "
        f"p50={np.median(span_ms):.3f}ms (p99 {np.percentile(wall_ms, 99):.3f} / "
        f"{np.percentile(span_ms, 99):.3f}ms) device seconds "
        f"{st.device_seconds:.3f} of {run['wall']:.3f}; "
        f"pack_efficiency={snap['pack_efficiency']} staging_overlap_ratio="
        f"{snap['staging_overlap_ratio']} (R, C, S) classes used {classes}; "
        f"sheds queue_full={st.sheds_queue_full} deadline={st.sheds_deadline} "
        f"predicted_deadline={st.sheds_predicted} ({retry.sheds} calls "
        f"retried); "
        f"peak device memory {peak / 2**30:.3f}GiB ({held / 2**30:.3f}GiB held "
        f"before)")
    assert st.texts == EMBED_TEXTS and st.packed_batches == len(window)
    assert st.sheds_queue_full == 0 and st.sheds_deadline == 0, snap
    PREDICTED_SHEDS["8"] = (st.sheds_predicted, retry.sheds)
    assert embs.shape == (EMBED_TEXTS, cfg.dims) and np.isfinite(embs).all()
    norms = np.linalg.norm(embs, axis=1)
    assert np.abs(norms - 1.0).max() <= 1e-3, ("norms", norms.min(), norms.max())
    if profile_dir:
        profile_embed(eng, texts, profile_dir)

    # -- 8.3 packed against the padded per-request path; a probe alone and
    # inside a full pack; the float32 gap (logged only)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 8)
    per = -(-EMBED_CHECK // len(EMBED_MIX))
    check = np.concatenate([
        rng.choice(np.flatnonzero(kinds == i), size=per, replace=False)
        for i in range(len(EMBED_MIX))])[:EMBED_CHECK]
    ref = np.stack(emb.embed_batch([texts[i] for i in check]))
    cos = (embs[check] * ref).sum(-1)
    by_kind = {m[0]: float(cos[kinds[check] == i].min())
               for i, m in enumerate(EMBED_MIX)}
    probe = tok.encode(texts[int(check[0])], max_len=packer.max_len)
    alone = packed(packer.pack([probe]))[0]
    titles = [tok.encode(texts[i], max_len=packer.max_len)
              for i in np.flatnonzero(kinds == 0)[1000:1512]]
    take, _, _ = packer.plan([len(probe)] + [len(s) for s in titles],
                             budget_tokens=8192, capacity=32)
    full = packer.pack([probe] + titles[:take - 1], capacity=32)
    inside = packed(full)[full.order.index(0)]
    probe_cos = float(np.dot(alone, inside))
    params32 = map_tree(lambda t: t.float(), params)
    emb32 = DeviceEmbedder(cfg=dataclasses.replace(cfg, dtype="float32"),
                           params=params32, tokenizer=tok, max_len=512,
                           device="cuda")
    ref32 = np.stack(emb32.embed_batch([texts[i] for i in check]))
    cos32 = (embs[check] * ref32).sum(-1)
    del emb32, params32
    torch.cuda.empty_cache()
    log(f"[phase8] packed vs per-request over {len(check)} texts: min cos "
        f"{cos.min():.6f} mean {cos.mean():.6f} (at least {EMBED_COS}) by kind "
        f"{json.dumps(by_kind)}; probe alone vs inside a {full.ids.shape} pack "
        f"of {full.n_segments} texts: cos {probe_cos:.6f}; float32 weights "
        f"(logged only): min cos {cos32.min():.6f} mean {cos32.mean():.6f}; "
        f"{time.perf_counter() - t0:.1f}s")
    assert cos.min() >= EMBED_COS, ("packed vs per-request", cos.min())
    assert full.n_segments > 1 and probe_cos >= EMBED_COS, (
        "segment leak", probe_cos)

    # -- 8.4 search what was embedded: the same engine embeds stored texts
    # again as queries; the service scans with the bf16 streaming kernel
    t0 = time.perf_counter()
    svc = SearchService(config=SearchConfig(batching_enabled=True),
                        device="cuda")
    svc.index_vectors([f"t{i}" for i in range(EMBED_TEXTS)], embs)
    corpus = svc.corpus()
    plan = S._streaming_plan(corpus.capacity, k)
    assert corpus.capacity >= S.STREAMING_MIN_ROWS and plan is not None, (
        "no streaming plan", corpus.capacity, plan)
    q_rows = rng.choice(EMBED_TEXTS, size=EMBED_QUERIES, replace=False)
    queries = np.stack(eng.embed_batch([texts[i] for i in q_rows]))
    log(f"[phase8] index + {EMBED_QUERIES} query embeddings "
        f"{time.perf_counter() - t0:.1f}s, capacity {corpus.capacity}, "
        f"streaming plan (tile_n, rows) {plan}")
    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    srun = drive_service(svc, queries, k, lambda: None)
    launches = K.launch_counts()["streaming_topk_bf16"]
    dispatches = corpus.sync_stats.device_dispatches - d0
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(queries, dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    del dev, valid
    rec = recall(srun["results"], gt_ids)
    own_rank, own_gap = [], []
    for res, row in zip(srun["results"], q_rows):
        ids = [i for i, _ in res]
        own = f"t{row}"
        own_rank.append(ids.index(own) if own in ids else -1)
        own_gap.append(res[0][1] - res[ids.index(own)][1] if own in ids
                       else float("inf"))
    own_rank, own_gap = np.array(own_rank), np.array(own_gap)
    sample = embs[rng.choice(EMBED_TEXTS, size=1024, replace=False)]
    pair = sample @ sample.T
    mean_pair = float((pair.sum() - np.trace(pair)) / (1024 * 1023))
    log(f"[phase8] search: {EMBED_QUERIES} queries from 32 clients in "
        f"{srun['wall']:.3f}s qps={EMBED_QUERIES / srun['wall']:.1f} client "
        f"p50={np.median(srun['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(srun['lat'], 99) * 1e3:.2f}ms dispatches="
        f"{dispatches} recall@{k}={rec:.4f}; own text in its top-{k}: "
        f"{int((own_rank >= 0).sum())}/{EMBED_QUERIES}, rank 1 "
        f"{float((own_rank == 0).mean()):.4f}, largest gap to the best "
        f"{own_gap.max():.5f} (at most {OWN_SCORE_TOL}); mean pairwise cosine "
        f"of 1024 stored embeddings {mean_pair:.4f} (random weights)")
    log(f"[phase8] streaming_topk_bf16 launches in the search step: {launches}")
    assert rec >= 0.95, ("embedded corpus recall", rec)
    assert (own_rank >= 0).all() and own_gap.max() <= OWN_SCORE_TOL, (
        "own text", own_rank.min(), own_gap.max())
    assert launches > 0, "the search missed the bf16 streaming kernel"
    assert dispatches < EMBED_QUERIES, ("no fusion", dispatches)
    svc.shutdown()
    return {"texts": texts, "embs": embs, "engine": eng,
            "embeddings_per_s": EMBED_TEXTS / run["wall"]}


def build_graph(texts: list, embs: np.ndarray, seed: int):
    """Phase 10.1: the port's ``DB(CHAIN_DIR/db10, Config())`` on the card
    (the durable chain ``open_storage`` assembles, the one ``cli serve``
    opens, under the default database's namespace) holding each phase-8
    text as node ``t<i>`` of ``db.storage`` (property ``content``, its
    phase-8 embedding) with RAG_EDGES[0]..RAG_EDGES[1] outgoing edges to
    seeded random nodes, flushed before the service serves, so the flusher
    is idle (not JSON-encoding under the interpreter lock) during the timed
    searches. Returns the DB."""
    import shutil

    from nornicdb_tpu_torch import DB, Config
    from nornicdb_tpu_torch.storage import Edge, Node

    # numpy float32 at the chain's door: it serialises them as JSON floats
    assert isinstance(embs, np.ndarray) and embs.dtype == np.float32
    free = shutil.disk_usage(os.path.dirname(CHAIN_DIR)).free
    log(f"[phase10] disk free under {os.path.dirname(CHAIN_DIR)}: {free} "
        f"bytes (the chain needs ~{CHAIN_MIN_FREE >> 30} GiB)")
    assert free >= CHAIN_MIN_FREE, ("disk", free)
    d = os.path.join(CHAIN_DIR, "db10")
    db = DB(d, Config())
    storage = db.storage
    hist0 = storage_hists()
    t0 = time.perf_counter()
    for i, text in enumerate(texts):
        storage.create_node(Node(id=f"t{i}", labels=["Doc"],
                                 properties={"content": text},
                                 embedding=embs[i]))
    t_nodes = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 10)
    deg = rng.integers(RAG_EDGES[0], RAG_EDGES[1] + 1, len(texts))
    src = np.repeat(np.arange(len(texts)), deg)
    dst = rng.integers(0, len(texts), src.size)
    t0 = time.perf_counter()
    for k, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        storage.create_edge(Edge(id=f"e{k}", start_node=f"t{a}",
                                 end_node=f"t{b}"))
    t_edges = time.perf_counter() - t0
    t0 = time.perf_counter()
    storage.flush()
    t_flush = time.perf_counter() - t0
    wal_bytes = os.path.getsize(os.path.join(d, "wal", "wal.log"))
    n, m = storage.node_count(), storage.edge_count()
    hist = {k: [a - b for a, b in zip(v, hist0[k])]
            for k, v in storage_hists().items()}
    enc, dec = json_costs(storage.batch_get_nodes(
        [f"t{i}" for i in range(0, len(texts), len(texts) // 256)]))
    log(f"[phase10] DB({d!r}, Config()) on {db.device}: storage "
        f"{type(db._base_storage).__name__} -> WALEngine -> MemoryEngine "
        f"under the {db.default_database!r} namespace: {n} nodes in "
        f"{t_nodes:.1f}s ({n / t_nodes:.1f}/s), "
        f"{m} edges in {t_edges:.1f}s ({m / t_edges:.1f}/s), then flush() "
        f"{t_flush:.2f}s; WAL {wal_bytes} bytes "
        f"({wal_bytes / (n + m):.1f} a record); WAL appends "
        f"{hist['wal_append'][1]:.0f} taking {hist['wal_append'][0]:.2f}s "
        f"(encode + write + flush to the OS), async flushes "
        f"{hist['async_flush'][1]:.0f} taking {hist['async_flush'][0]:.2f}s "
        f"(the appends plus the base engine's inserts); a node record's "
        f"to_dict + json.dumps {enc * 1e3:.3f}ms and json.loads + from_dict "
        f"{dec * 1e3:.3f}ms (256 sampled): {enc * n:.1f}s / {dec * n:.1f}s "
        f"over the {n} nodes")
    return db


def storage_hists() -> dict:
    """(sum, count) of the WAL append and async flush histograms."""
    from nornicdb_tpu_torch.telemetry import REGISTRY

    out = {}
    for key, fam in (("wal_append", "nornicdb_wal_append_seconds"),
                     ("async_flush", "nornicdb_async_flush_seconds")):
        _, total, count = REGISTRY._families[fam].labels().snapshot()
        out[key] = [total, count]
    return out


def json_costs(nodes: list) -> tuple[float, float]:
    """Seconds a node record takes to encode as the WAL writes it
    (``to_dict`` + ``json.dumps``) and to decode as recovery reads it
    (``json.loads`` + ``Node.from_dict``), the mean over ``nodes``."""
    from nornicdb_tpu_torch.storage import Node

    t0 = time.perf_counter()
    blobs = [json.dumps(x.to_dict(), separators=(",", ":")) for x in nodes]
    enc = (time.perf_counter() - t0) / len(nodes)
    t0 = time.perf_counter()
    for b in blobs:
        Node.from_dict(json.loads(b))
    dec = (time.perf_counter() - t0) / len(nodes)
    return enc, dec


class _Spans:
    """perf_counter spans of the search a client thread runs, taken by
    wrapping the service's stages in this script (the package has no
    timers): each wrapped stage adds its seconds, arguments and result to
    the thread's record while one is open."""

    def __init__(self):
        self.local = threading.local()

    def begin(self) -> dict:
        self.local.rec = {}
        return self.local.rec

    def end(self) -> None:
        self.local.rec = None

    def wrap(self, name: str, fn):
        local = self.local

        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            rec = getattr(local, "rec", None)
            if rec is not None:
                rec[name] = rec.get(name, 0.0) + time.perf_counter() - t
                rec[name + "_in"], rec[name + "_out"] = a, out
            return out

        return timed


class _SpanEmbedder:
    """The service's embedder with its ``embed`` timed."""

    def __init__(self, inner, spans: _Spans):
        self.inner = inner
        self.embed = spans.wrap("embed", inner.embed)

    def dimensions(self) -> int:
        return self.inner.dimensions()


class _Backoff:
    """How a client answers the serving engines' load shedding: a
    ResourceExhausted (the 429 of the HTTP edge; a queue-full, deadline or
    predicted-deadline shed) is retried after a backoff that doubles from
    50 ms, at most BACKOFF_TRIES times. Counts the sheds and the longest
    run of them one call met, which the phase logs."""

    def __init__(self):
        self.sheds = 0
        self.longest = 0
        self._mu = threading.Lock()

    def __call__(self, fn, *a, **kw):
        from nornicdb_tpu_torch.errors import ResourceExhausted

        delay = 0.05
        for tries in range(1, BACKOFF_TRIES):
            try:
                return fn(*a, **kw)
            except ResourceExhausted:
                with self._mu:
                    self.sheds += 1
                    self.longest = max(self.longest, tries)
                time.sleep(delay)
                delay = min(2 * delay, 1.0)
        return fn(*a, **kw)


def recorded_search(svc, spans: _Spans, query: str) -> tuple:
    """``search(query)`` and the record of its stages' spans, inside the
    trace root an HTTP request would start (the service's tracer spans
    land in it)."""
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    rec = spans.begin()
    with tracer.start_trace("chip_smoke.search"):
        return svc.search(query, limit=HYBRID_LIMIT), rec


def tracer_p50s(names: tuple) -> dict:
    """name -> (spans, p50 ms) over every trace in the tracer's ring."""
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    durations: dict = {n: [] for n in names}
    for summary in tracer.traces(limit=tracer.count()):
        entry = tracer.trace(summary["trace_id"]) or {"spans": []}
        for rec in entry["spans"]:
            if rec["name"] in durations:
                durations[rec["name"]].append(rec["duration_ms"])
    return {n: (len(d), float(np.median(d)) if d else float("nan"))
            for n, d in durations.items()}


def phase10_telemetry(svc, texts: list, retry: _Backoff,
                      script_p50: dict) -> None:
    """Phase 10.7, the telemetry plane over the live hybrid service: the
    device-residency gauge against the corpus tensors, a profile capture
    while CAPTURE_THREADS threads search (the capture must hold #2's
    launches, made on the batcher's thread), and the tracer's span p50s
    beside the script's own."""
    import io
    import tarfile

    import torch

    from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
    from nornicdb_tpu_torch.telemetry import deviceprof

    # -- the device-residency gauge: every live corpus's tensors
    deviceprof.PROFILER.refresh_hbm()
    hbm = deviceprof.snapshot()["hbm_bytes"]
    owners = [ref() for ref, _ in list(
        deviceprof.PROFILER._hbm_providers.values())]
    corpora = [c for c in owners if isinstance(c, DeviceCorpus)]
    assert svc.corpus() in corpora

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    want = {"corpus_f32": sum(nbytes(c._dev, c._dev_valid) for c in corpora),
            "corpus_int8": sum(nbytes(*(c._dev_i8 or ())) for c in corpora),
            "ivf": sum(nbytes(c._ivf.blocks, c._ivf.counts,
                              c._ivf.centroids, c._ivf.residual,
                              c._ivf.residual_valid)
                       for c in corpora if c._ivf is not None)}
    allocated = torch.cuda.memory_allocated()
    log(f"[phase10] hbm gauge {json.dumps(hbm)} against the tensors of "
        f"{len(corpora)} live corpora {json.dumps(want)}; "
        f"memory_allocated {allocated}")
    for comp, b in want.items():
        assert hbm[comp] == b, ("nornicdb_hbm_bytes", comp, hbm[comp], b)
    assert hbm["corpus_f32"] > 0
    assert sum(hbm[c] for c in want) <= allocated

    # -- a profile capture while the clients search (fresh queries: a
    # cached ranking would launch nothing)
    stop = threading.Event()
    served = [0]

    def client(t: int) -> None:
        j = 0
        while not stop.is_set():
            q = f"{two_words(texts[(t * 7919 + j * 104729) % len(texts)])} " \
                f"capture{t}x{j}"
            retry(svc.search, q, limit=HYBRID_LIMIT)
            served[0] += 1
            j += 1

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(CAPTURE_THREADS)]
    for th in threads:
        th.start()
    time.sleep(0.5)  # the clients are searching before the window opens
    try:
        t0 = time.perf_counter()
        blob = deviceprof.capture_profile(CAPTURE_SECONDS)
        t_cap = time.perf_counter() - t0
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        names = tar.getnames()
        trace = json.load(tar.extractfile(
            next(n for n in names if n.endswith(".json"))))
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    topk = [e for e in kernels if "streaming_topk_bf16" in e.get("name", "")]
    corr = {e.get("args", {}).get("correlation") for e in topk}
    launch_tids = sorted({e.get("tid") for e in trace["traceEvents"]
                          if e.get("cat") == "cuda_runtime"
                          and e.get("args", {}).get("correlation") in corr})
    log(f"[phase10] profile capture {CAPTURE_SECONDS:g}s while "
        f"{CAPTURE_THREADS} threads searched ({served[0]} searches): "
        f"{len(blob)} bytes in {t_cap:.2f}s, files {names}, "
        f"{len(trace['traceEvents'])} events, {len(kernels)} kernels, "
        f"{len(topk)} launches of #2; their launching host threads {launch_tids} "
        f"(the capturing thread {threading.get_native_id()} only slept)")
    assert topk, "the capture holds no launch of the bf16 kernel"

    # -- the tracer's spans beside the script's
    tp = tracer_p50s(("search.embed", "search.rank", "search.vector",
                      "search.queue_wait", "search.batch"))
    log("[phase10] tracer span p50s: " + ", ".join(
        f"{n} {p:.2f}ms ({k} spans)" for n, (k, p) in tp.items())
        + "; the script's spans: " + ", ".join(
        f"{n} {p:.2f}ms" for n, p in script_p50.items())
        + " (batching on: the vector leg records search.queue_wait and "
        "search.batch, search.vector only when unbatched)")
    assert tp["search.rank"][0] > 0 and tp["search.embed"][0] > 0


def two_words(text: str) -> str:
    """A keyword-like query: the last two words of a stored text (its last
    word is unique to it)."""
    return " ".join(text.split()[-2:])


def _fused_head(rec: dict, query: str, cfg) -> list:
    """The ranking ``_rank`` must give for one search, computed here from
    the legs it recorded: fuse_rrf with the adaptive weights, cut to the
    service's head."""
    from nornicdb_tpu_torch.search.fusion import adaptive_rrf_weights, fuse_rrf

    ranked = {}
    if rec.get("vector_out") is not None:
        ranked["vector"] = [i for i, _ in rec["vector_out"]]
    if rec.get("bm25_out"):
        ranked["fulltext"] = [i for i, _ in rec["bm25_out"]]
    return fuse_rrf(ranked, adaptive_rrf_weights(query), cfg.rrf_k)


def drive_hybrid(svc, spans: _Spans, queries: list, storage, embedder,
                 seed: int, retry: _Backoff) -> dict:
    """Phase 10.3: HYBRID_CLIENTS closed-loop clients run ``search`` over
    ``queries`` while HYBRID_WRITERS threads make HYBRID_WRITES
    create/update/delete calls through the storage. Each acknowledged write
    is read back: after a create or an update a search for the written text
    returns the node (a search for the new text just before the update
    cached a ranking without it, so a stale cache would fail), after a
    delete it never does. Every call goes through ``retry``."""
    from nornicdb_tpu_torch.storage import Node

    n = len(queries)
    results: list = [None] * n
    recs: list = [None] * n
    lat = np.zeros(n)
    errors: list = []
    deleted: set = set()
    acks = {"writes": 0, "rank1": 0, "stale_guarded": 0}
    mu = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t, n, HYBRID_CLIENTS):
                t1 = time.perf_counter()
                results[i], recs[i] = retry(recorded_search, svc, spans,
                                            queries[i])
                lat[i] = time.perf_counter() - t1
                spans.end()
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    def written(w: int, c: int, v: int, wrng) -> str:
        return f"{wrng.choice(EMBED_WORDS)} wr{w}c{c}v{v} note{w}x{c}x{v}"

    def found(text: str) -> list:
        return [r["id"] for r in retry(svc.search, text, limit=HYBRID_LIMIT)]

    def writer(w: int) -> None:
        wrng = np.random.default_rng(seed + 100 + w)
        try:
            for c in range(HYBRID_WRITES // HYBRID_WRITERS // 4):
                nid = f"w{w}_{c}"
                text = written(w, c, 0, wrng)
                storage.create_node(Node(
                    id=nid, labels=["Note"], properties={"content": text},
                    embedding=retry(embedder.embed, text)))
                ids = found(text)
                assert nid in ids, ("created node not served", nid, ids)
                with mu:
                    acks["writes"] += 1
                    acks["rank1"] += ids[0] == nid
                for v in (1, 2):
                    new = written(w, c, v, wrng)
                    before = found(new)  # cached: a ranking without it
                    node = storage.get_node(nid)
                    node.properties["content"] = new
                    node.embedding = retry(embedder.embed, new)
                    storage.update_node(node)
                    ids = found(new)
                    assert nid in ids, ("updated node not served", nid, ids)
                    text = new
                    with mu:
                        acks["writes"] += 1
                        acks["rank1"] += ids[0] == nid
                        acks["stale_guarded"] += nid not in before
                with mu:
                    deleted.add(nid)
                storage.delete_node(nid)
                ids = found(text)
                assert nid not in ids, ("deleted node served", nid)
                with mu:
                    acks["writes"] += 1
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = ([threading.Thread(target=client, args=(t,))
                for t in range(HYBRID_CLIENTS)]
               + [threading.Thread(target=writer, args=(w,))
                  for w in range(HYBRID_WRITERS)])
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads[:HYBRID_CLIENTS]:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    for th in threads[HYBRID_CLIENTS:]:
        th.join(timeout=600)
    wall_writes = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "hybrid thread hung"
    assert acks["writes"] == HYBRID_WRITES, acks
    return dict(results=results, recs=recs, lat=lat, wall=wall,
                wall_writes=wall_writes, deleted=deleted, acks=acks)


def in_threads(fn, items: list, n_threads: int = 16) -> None:
    """``fn`` over ``items`` from ``n_threads`` threads; errors re-raised."""
    errors: list = []

    def worker(t: int) -> None:
        try:
            for item in items[t::n_threads]:
                fn(item)
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "thread hung"


def wait_drained(corpus, timeout: float = 30.0) -> None:
    """Until the write-behind uploader has patched every dirty block."""
    deadline = time.perf_counter() + timeout
    while corpus._dirty_blocks or corpus._full_dirty:
        assert time.perf_counter() < deadline, "uploader did not drain"
        time.sleep(0.002)


def phase_hybrid(K, seed: int, served: dict, beside=()) -> dict:
    """Phase 10: hybrid search over phase 8's corpus in the port's DB (graph
    of build_graph): ``db.set_embedder(CachedEmbedder(<phase 8's engine>))``
    (the ``cli serve`` stack; it starts the DB's EmbedWorker), then
    ``db.search``, the DB's SearchService, attached and indexed from
    storage on first use, with its options set as a JAX user sets them
    (``search.configure_defaults``): write-behind and batching on,
    candidates_multiplier 4. The writers embed their texts through the same
    cached embedder and write through ``db.storage``. Then the traffic of
    drive_hybrid, and the checks of fusion, vector-leg recall, own nodes,
    the rank cache, the cross-encoder rerank and MMR; the telemetry plane;
    10.8, the learning loop through ``db.store``; 10.7's record for phase
    14. Returns the DB (phase 9 retrieves and generates through it), #2's
    launches in the traffic and the record. ``beside``: the card children
    that run beside 10.1's build; 10.2 waits for them, so that the
    traffic runs with no child on the card."""
    import dataclasses as dc

    import torch

    from nornicdb_tpu_torch._device import map_tree
    from nornicdb_tpu_torch.embed import CachedEmbedder
    from nornicdb_tpu_torch.models import bge_m3 as B
    from nornicdb_tpu_torch.search import service as SV
    from nornicdb_tpu_torch.search.bm25 import BM25Index
    from nornicdb_tpu_torch.search.fusion import apply_mmr
    from nornicdb_tpu_torch.search.rerank import CrossEncoderReranker
    from nornicdb_tpu_torch.storage import Node

    texts, embs = served["texts"], served["embs"]
    eng = CachedEmbedder(served["engine"])
    torch.cuda.reset_peak_memory_stats()
    at_start = states(*beside)
    db = build_graph(texts, embs, seed)
    at_end = states(*beside)
    t0 = time.perf_counter()
    for child in beside:
        child.wait()
    log(f"[phase10] 10.1 beside the card children: at its start "
        f"{at_start}; at its end {at_end}; waited "
        f"{time.perf_counter() - t0:.1f}s for them")
    storage = db.storage

    # -- 10.2 the DB's service, attached and indexed from storage
    # tune_enabled=False: the DB's debounced recluster (fired by 10.8's
    # burst) fits k-means for the cluster integration but installs no IVF
    # plan, so every retrieval of phases 10, 9 and 14a full-scans through
    # #2 whenever the recluster lands (phase 7 holds the tuned plan)
    options = {"candidates_multiplier": 4, "write_behind": True,
               "batching_enabled": True, "tune_enabled": False}
    SV.configure_defaults(**options)
    log(f"[phase10] search options through search.configure_defaults"
        f"({', '.join(f'{k}={v}' for k, v in options.items())}), as a "
        f"server installs its search section; no NORNICDB_SEARCH_* set: "
        f"{sorted(k for k in os.environ if k.startswith('NORNICDB_SEARCH_'))}")
    db.set_embedder(eng)
    spans = _Spans()
    retry = _Backoff()
    sheds0 = served["engine"].stats.sheds_deadline
    bm25_index = BM25Index.index
    bm25_s = [0.0]

    def timed_index(self, doc_id, text):
        t = time.perf_counter()
        bm25_index(self, doc_id, text)
        bm25_s[0] += time.perf_counter() - t

    BM25Index.index = timed_index
    try:
        t0 = time.perf_counter()
        svc = db.search  # built, attached and indexed on first use
        t_build = time.perf_counter() - t0
    finally:
        BM25Index.index = bm25_index
    n_indexed = svc.stats.indexed
    cfg = svc.config
    assert (cfg.candidates_multiplier, cfg.write_behind,
            cfg.batching_enabled) == (4, True, True), cfg
    assert svc.embedder is eng and svc.device.type == "cuda"
    corpus = svc.corpus()
    wait_drained(corpus)
    t_drain = time.perf_counter() - t0 - t_build
    sync0 = corpus.sync_stats.as_dict()
    log(f"[phase10] db.search: build_indexes {n_indexed} nodes in "
        f"{t_build:.2f}s (BM25 "
        f"index {bm25_s[0]:.2f}s, fingerprints + corpus adds + locks "
        f"{t_build - bm25_s[0]:.2f}s), uploader drained {t_drain:.3f}s "
        f"later; BM25 docs {len(svc._bm25)}, corpus rows {len(corpus)} "
        f"capacity {corpus.capacity}; sync {json.dumps(sync0)}")
    assert n_indexed == len(texts) == len(svc._bm25) == len(corpus)
    assert corpus._uploader is not None and sync0["uploader_runs"] > 0

    # -- 10.3 the traffic: half stored texts, half their last two words
    rng = np.random.default_rng(seed + 11)
    n_q = HYBRID_CLIENTS * HYBRID_PER_CLIENT
    rows = rng.choice(len(texts), size=n_q + HYBRID_RERANK + HYBRID_MMR,
                      replace=False)
    q_rows = rows[:n_q]
    queries = [texts[r] if i % 2 == 0 else two_words(texts[r])
               for i, r in enumerate(q_rows)]
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    # every traced search of the phase stays in the ring
    tracer.configure(capacity=4096)
    tracer.clear()
    svc.embedder = _SpanEmbedder(eng, spans)
    svc.vector_candidates = spans.wrap("vector", svc.vector_candidates)
    svc._bm25.search = spans.wrap("bm25", svc._bm25.search)
    svc._enrich = spans.wrap("enrich", svc._enrich)
    svc._rank = spans.wrap("rank", svc._rank)
    fuse = SV.fuse_rrf
    SV.fuse_rrf = spans.wrap("fusion", fuse)
    try:
        K.reset_launch_counts()
        s0 = dc.replace(corpus.sync_stats)
        run = drive_hybrid(svc, spans, queries, storage, eng, seed, retry)
        launches = K.launch_counts()["streaming_topk_bf16"]
        s1 = dc.replace(corpus.sync_stats)
        wait_drained(corpus)
        deleted = run["deleted"]

        # fusion: each ranking is fuse_rrf of its two legs
        ranked, hits_in_traffic = 0, 0
        for q, res, rec in zip(queries, run["results"], run["recs"]):
            if "rank" not in rec:
                hits_in_traffic += 1
                continue
            ranked += 1
            head = _fused_head(rec, q, cfg)[:max(HYBRID_LIMIT,
                                                 cfg.rerank_candidates)]
            got_ids = {r["id"] for r in res}
            want = [(i, sc) for i, sc in head
                    if i in got_ids or i not in deleted][:HYBRID_LIMIT]
            assert [(r["id"], r["score"]) for r in res] == want, (
                "fusion", q)
        # the vector leg against an exact float32 scan of the same rows
        legs = [(rec["vector_in"][0], rec["vector_out"])
                for rec in run["recs"] if "rank" in rec]
        qv = np.stack([np.asarray(e, np.float32) for e, _ in legs])
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        n_cand = HYBRID_LIMIT * cfg.candidates_multiplier
        with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
            gt = ground_truth(qv, dev, valid, n_cand)
            gt_ids = [{slot_ids[s] for s in g} for g in gt]
        del dev, valid
        rec_leg = recall([leg for _, leg in legs], gt_ids)
        writer_hits = sum(1 for _, leg in legs for i, _ in leg
                          if i.startswith("w"))
        # own node: rank 1 and top-10 shares by half
        own = np.array([[r["id"] for r in res].index(f"t{row}")
                        if f"t{row}" in [r["id"] for r in res] else -1
                        for res, row in zip(run["results"], q_rows)])
        top_stored = float((own[0::2] >= 0).mean())
        top_words = float((own[1::2] >= 0).mean())
        # the share of a search in each stage
        span = {k: sum(rec.get(k, 0.0) for rec in run["recs"])
                for k in ("embed", "vector", "bm25", "fusion", "enrich")}
        total = float(run["lat"].sum())
        lat = run["lat"]
        embed_ms = np.array([rec.get("embed", 0.0) for rec in run["recs"]
                             if "rank" in rec]) * 1e3
        script_p50 = {k: float(np.median([rec[k] for rec in run["recs"]
                                          if k in rec])) * 1e3
                      for k in ("embed", "rank", "vector")}
        log(f"[phase10] {n_q} searches from {HYBRID_CLIENTS} clients in "
            f"{run['wall']:.3f}s qps={n_q / run['wall']:.1f} client "
            f"p50={np.median(lat) * 1e3:.2f}ms "
            f"p99={np.percentile(lat, 99) * 1e3:.2f}ms "
            f"(stored-text half p50 {np.median(lat[0::2]) * 1e3:.2f}ms, "
            f"two-word half {np.median(lat[1::2]) * 1e3:.2f}ms); "
            f"{HYBRID_WRITES} writes from {HYBRID_WRITERS} writers done at "
            f"{run['wall_writes']:.3f}s, {run['acks']['rank1']} of "
            f"{HYBRID_WRITES * 3 // 4} written texts served their node first, "
            f"{run['acks']['stale_guarded']} updates read back through a "
            f"cached ranking made before them; share of search time: "
            + ", ".join(f"{k} {v / total:.4f}" for k, v in span.items())
            + f", other {1 - sum(span.values()) / total:.4f} (of "
            f"{total:.3f}s summed over the searches); the embed span p50 "
            f"{np.median(embed_ms):.2f}ms p99 {np.percentile(embed_ms, 99):.2f}"
            f"ms max {embed_ms.max():.2f}ms (the engine sheds past "
            f"{served['engine'].config.deadline_ms:.0f}ms: "
            f"{served['engine'].stats.sheds_deadline - sheds0} embed sheds, "
            f"{retry.sheds} calls retried, at most {retry.longest} sheds "
            f"running for one call of the {BACKOFF_TRIES} tries a client "
            f"makes)")
        log(f"[phase10] fusion equal to fuse_rrf of the legs on {ranked} "
            f"ranked searches ({hits_in_traffic} cache hits); vector leg "
            f"recall@{n_cand}={rec_leg:.4f} against an exact float32 scan "
            f"({writer_hits} writer nodes in the legs); own node first "
            f"{float((own[0::2] == 0).mean()):.4f} / "
            f"{float((own[1::2] == 0).mean()):.4f}, in the top "
            f"{HYBRID_LIMIT} {top_stored:.4f} / {top_words:.4f} (stored text / "
            f"two words); uploader runs "
            f"{s1.uploader_runs - s0.uploader_runs} patches "
            f"{s1.patches - s0.patches} full uploads "
            f"{s1.full_uploads - s0.full_uploads} errors "
            f"{s1.uploader_errors}, query stall "
            f"{(s1.query_stall_s - s0.query_stall_s) * 1e3:.2f}ms")
        log(f"[phase10] streaming_topk_bf16 launches in the traffic: "
            f"{launches}")
        assert ranked + hits_in_traffic == n_q
        assert rec_leg >= 0.95, ("vector leg recall", rec_leg)
        assert top_stored >= 0.99, ("own node", top_stored)
        assert launches > 0, "the vector leg missed the bf16 kernel"
        assert s1.uploader_errors == 0

        # -- 10.4 the rank cache: repeats hit, a text change misses, a
        # recall's touches change nothing
        t0 = time.perf_counter()
        x_text = "cache probe node uniqx"
        storage.create_node(Node(id="x0", properties={"content": x_text},
                                 embedding=retry(eng.embed, x_text)))
        repeat = queries[1::2][:HYBRID_REPEATS]  # two-word queries
        in_threads(lambda q: retry(svc.search, q, limit=HYBRID_LIMIT), repeat)
        searches0 = svc.stats.searches
        rank_calls: list = []
        rank = svc._rank

        def counted_rank(*a, **kw):
            out = rank(*a, **kw)
            rank_calls.append(a[0])
            return out

        svc._rank = counted_rank
        K.reset_launch_counts()
        hit_lat = []
        for q in repeat:
            t1 = time.perf_counter()
            svc.search(q, limit=HYBRID_LIMIT)
            hit_lat.append(time.perf_counter() - t1)
        hit_launches = K.launch_counts()["streaming_topk_bf16"]
        assert not rank_calls and hit_launches == 0, (
            "repeats not served from the cache", len(rank_calls),
            hit_launches)
        node = storage.get_node("x0")
        node.properties["content"] = x_text + " changed"
        storage.update_node(node)
        in_threads(lambda q: retry(svc.search, q, limit=HYBRID_LIMIT), repeat)
        assert len(rank_calls) == HYBRID_REPEATS, (
            "an update left cached rankings alive", len(rank_calls))
        wait_drained(corpus)
        gen, epoch = svc._generation, corpus.stats()["epoch"]
        touched = retry(svc.search, queries[0], limit=HYBRID_LIMIT)
        for r in touched:  # DB.recall's touch
            node = storage.get_node(r["id"])
            node.access_count += 1
            node.last_accessed = time.time()
            storage.update_node(node)
        n_rank = len(rank_calls)
        svc.search(queries[0], limit=HYBRID_LIMIT)
        assert svc._generation == gen and corpus.stats()["epoch"] == epoch
        assert not corpus._dirty_blocks and len(rank_calls) == n_rank, (
            "a touch dirtied the index")
        log(f"[phase10] rank cache: {HYBRID_REPEATS} repeats all hits "
            f"(0 ranks, 0 launches of #2), hit p50 "
            f"{np.median(hit_lat) * 1e3:.3f}ms; one update_node of a text: "
            f"all {HYBRID_REPEATS} repeats ranked again; {len(touched)} "
            f"touches (access count) left generation {gen}, corpus epoch "
            f"{epoch} and the dirty blocks as they were; "
            f"{svc.stats.searches - searches0} searches, "
            f"{time.perf_counter() - t0:.1f}s")
        svc._rank = rank

        # -- 10.5 the cross-encoder at bge-m3's width, against float32
        t0 = time.perf_counter()
        rr = CrossEncoderReranker(cfg=B.BGE_M3, seed=seed + 10,
                                  device="cuda")
        rr.score_pairs(texts[0], texts[1:1 + cfg.rerank_candidates])  # warm
        sync()
        t_init = time.perf_counter() - t0
        rr_log: list = []
        rerank = rr.rerank

        def recorded_rerank(query, candidates, limit=0):
            t1 = time.perf_counter()
            out = rerank(query, candidates, limit)
            rr_log.append((query, candidates, out,
                           time.perf_counter() - t1))
            return out

        rr.rerank = recorded_rerank
        svc.set_reranker(rr)
        svc.config.rerank_enabled = True
        rr_rows = rows[n_q:n_q + HYBRID_RERANK]
        rr_res = [retry(svc.search, two_words(texts[r]), limit=HYBRID_LIMIT)
                  for r in rr_rows]
        svc.config.rerank_enabled = False
        assert len(rr_log) == HYBRID_RERANK
        params32 = map_tree(lambda t: t.float(), rr.params)
        ref = CrossEncoderReranker(cfg=dc.replace(B.BGE_M3, dtype="float32"),
                                   params=params32, head=rr.head,
                                   tokenizer=rr.tokenizer,
                                   max_len=rr.max_len, device="cuda")
        err = 0.0
        widths = []
        for (q, cands, out, _), res in zip(rr_log, rr_res):
            assert len(cands) == cfg.rerank_candidates
            scores = [sc for _, sc in out]
            assert scores == sorted(scores, reverse=True)
            assert [r["id"] for r in res] == [i for i, _ in out][
                :HYBRID_LIMIT], ("reranked head", q)
            want = ref.score_pairs(q, [t for _, t in cands])
            got = dict(out)
            err = max(err, max(abs(got[c[0]] - float(w))
                               for c, w in zip(cands, want)))
            widths.append(len(rr.tokenizer.encode_batch(
                [f"{q} [SEP] {t}" for _, t in cands],
                max_len=rr.max_len)[0][0]))
        del ref, params32
        torch.cuda.empty_cache()
        rr_ms = np.array([dt for *_, dt in rr_log]) * 1e3
        log(f"[phase10] rerank: BGE_M3 cross-encoder (bf16, seed "
            f"{seed + 10}) built and warmed in {t_init:.2f}s; "
            f"{HYBRID_RERANK} searches with {cfg.rerank_candidates} "
            f"candidates, forward p50 {np.median(rr_ms):.2f}ms p99 "
            f"{np.percentile(rr_ms, 99):.2f}ms at (20, {int(np.min(widths))}"
            f"-{int(np.max(widths))}) tokens; the head ordered by its "
            f"scores; max |bf16 - float32| {err:.6f} (at most {RERANK_TOL})")
        assert err <= RERANK_TOL, ("rerank vs float32", err)

        # -- 10.6 MMR against the host apply_mmr on the same inputs
        svc.config.mmr_enabled = True
        mmr_rows = rows[n_q + HYBRID_RERANK:]
        changed = 0
        for r in mmr_rows:
            q = two_words(texts[r])
            res, rec = retry(recorded_search, svc, spans, q)
            spans.end()
            fused = _fused_head(rec, q, cfg)
            order = [i for i, _ in fused]
            vecs = {}
            for i in order:
                e = np.asarray(storage.get_node(i).embedding, np.float32)
                vecs[i] = e / np.linalg.norm(e)
            want = apply_mmr(order, dict(fused), vecs, HYBRID_LIMIT,
                             cfg.mmr_lambda)
            assert [x["id"] for x in res] == want, ("mmr", r)
            changed += want != order[:HYBRID_LIMIT]
        svc.config.mmr_enabled = False
        log(f"[phase10] MMR (lambda {cfg.mmr_lambda}): {HYBRID_MMR} "
            f"searches equal to the host apply_mmr over storage's vectors, "
            f"{changed} of them reordered against plain fusion; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f}GiB")
    finally:
        SV.fuse_rrf = fuse
        svc.embedder = eng
        for name in ("vector_candidates", "_enrich", "_rank"):
            svc.__dict__.pop(name, None)
        svc._bm25.__dict__.pop("search", None)
        svc.set_reranker(None)
    t0 = time.perf_counter()
    phase10_telemetry(svc, texts, retry, script_p50)
    log(f"[phase10] telemetry checks {time.perf_counter() - t0:.1f}s")
    PREDICTED_SHEDS["10"] = (served["engine"].stats.sheds_predicted
                             - PREDICTED_SHEDS["8"][0], retry.sheds)
    t0 = time.perf_counter()
    # DB.temporal read before 10.8: from now on each touch is recorded
    tracker = db.temporal
    learned = phase_learning(K, db, eng, texts, seed)
    check_temporal(tracker, learned["touched"])
    log(f"[phase10] 10.8 {time.perf_counter() - t0:.1f}s")
    record = record_chain(db, cfg, texts, run, seed, learned)
    return {"db": db, "streaming_topk_bf16": launches, "record": record,
            "learned": learned}


def _cluster_watch(db) -> dict:
    """Wrap the EmbedWorker's debounced cluster trigger (``db.search.
    recluster()``, fired after LEARN-sized bursts settle for the worker's
    cluster_quiet_period) to record when it started and ended."""
    w = db._embed_worker
    fired: dict = {"start": [], "end": [], "error": []}
    trigger = w.on_cluster_trigger

    def recorded() -> None:
        fired["start"].append(time.perf_counter())
        try:
            trigger()
        except Exception as e:  # the worker counts and logs it too
            fired["error"].append(repr(e))
            raise
        finally:
            fired["end"].append(time.perf_counter())

    w.on_cluster_trigger = recorded
    fired["quiet_s"] = w.config.cluster_quiet_period
    return fired


def cluster_report(fired: dict, t_ref: float) -> str:
    """Whether the debounced recluster fired, and when (seconds after
    ``t_ref``)."""
    if not fired["start"]:
        return (f"the debounced recluster has not fired (quiet period "
                f"{fired['quiet_s']:g}s)")
    ends = [f"{e - t_ref:.1f}" for e in fired["end"]]
    return (f"the debounced recluster fired {len(fired['start'])}x at "
            f"{[f'{t - t_ref:.1f}' for t in fired['start']]}s, ended at "
            f"{ends}s, errors {fired['error']}")


def phase_learning(K, db, embedder, stored: list, seed: int) -> dict:
    """Phase 10.8, the learning loop through the DB's own API: LEARN_TEXTS
    new texts stored with ``db.store`` by LEARN_CLIENTS clients; the DB's
    EmbedWorker embeds them through phase 8's engine (``embedder``, the
    CachedEmbedder the DB holds) and writes them back; ``_on_embedded``
    feeds ``InferenceEngine.on_store``, whose similarity lookup is
    ``db.search.vector_candidates`` (kernel #2). Then LEARN_REEMBED of them
    are marked pending again: each re-embed runs on_store a second time,
    and pairs observed twice (min_evidence = 2) become SIMILAR_TO edges.
    Checks the drain deadline, the worker's counts, the swallowed-error
    counters, the embeddings against the embedder's, recall of the learned
    texts, and each inferred edge's cosine and confidence."""
    import torch

    from nornicdb_tpu_torch.telemetry.costmodel import COST_MODEL
    from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

    errors = REGISTRY._families["nornicdb_component_errors_total"]
    watched = ("embed_queue", "inference.similarity", "inference.create_edge")
    err0 = {c: errors.labels(c).value for c in watched}
    base = build_texts(LEARN_TEXTS, seed + 1)[0]
    # the mix of phase 8, each text's unique last word made one no stored
    # text has (stored texts end in n<i>)
    texts = [t.rsplit(" ", 1)[0] + f" l{i}" for i, t in enumerate(base)]
    assert not set(texts) & set(stored)
    # The process-wide cost model keeps what phase 10's traffic taught it:
    # its per-token EWMA, learned from one-text query packs under 32
    # threads' interpreter lock, predicts a 32-text worker batch past the
    # engine's deadline (PERF.md, section 7). The worker submits to an
    # idle engine, which admits such a request as a probe; the prediction
    # and the embed route's admission decisions in the loop are logged.
    units = sum(len(t.split()) + 2 for t in texts[:32])
    stale, conf = COST_MODEL.predict("serving", "embed", units)
    log(f"[phase10] 10.8 the cost model's prediction for a 32-text worker "
        f"batch ({units} tokens) after phase 10's traffic: "
        f"{stale * 1e3:.1f}ms (x{COST_MODEL.conservatism} against the "
        f"{embedder.inner.config.deadline_ms:.0f}ms deadline; confidence "
        f"{conf:.3f})")
    admissions = REGISTRY._families["nornicdb_cost_model_admission_total"]
    decisions = ("admit", "probe", "shed", "fail_open")
    adm0 = {d: admissions.labels("embed", d).value for d in decisions}
    sheds0 = embedder.inner.stats.sheds_predicted
    ids = [f"l{i}" for i in range(LEARN_TEXTS)]
    worker = db._embed_worker
    inf = db.inference
    thr = inf.config.similarity_threshold
    st0 = dict(vars(worker.stats))
    inf0 = dict(vars(inf.stats))
    fired = _cluster_watch(db)

    # timestamps: store return, the on_embedded hook (the node indexed),
    # on_store's own time, and every observation the evidence gate took
    t_store: dict = {}
    t_indexed: dict = {}
    on_store_ms: list = []
    obs: dict = {}       # (a, b, type) -> scores accumulated as evidence
    created: dict = {}   # edge id -> (a, b, type, scores it was made from)
    hook = worker.on_embedded
    on_store = inf.on_store
    suggest = inf.process_suggestion

    def recorded_embedded(node) -> None:
        t_indexed.setdefault(node.id.split(":", 1)[1],
                             time.perf_counter())
        hook(node)

    def timed_on_store(node):
        if node.embedding is None:  # DB.store's own call: nothing to match
            return on_store(node)
        t = time.perf_counter()
        try:
            return on_store(node)
        finally:
            on_store_ms.append((time.perf_counter() - t) * 1e3)

    def recorded_suggest(a, b, rel, conf):
        key = (*sorted((a, b)), rel)
        c0 = (inf.stats.suppressed_cooldown, inf.stats.suppressed_existing)
        edge = suggest(a, b, rel, conf)
        if (inf.stats.suppressed_cooldown,
                inf.stats.suppressed_existing) == c0:
            obs.setdefault(key, []).append(float(conf))
        if edge is not None:
            created[edge.id] = (edge.start_node, edge.end_node, rel,
                                obs.pop(key))
        return edge

    worker.on_embedded = recorded_embedded
    inf.on_store = timed_on_store
    inf.process_suggestion = recorded_suggest
    K.reset_launch_counts()
    errs: list = []

    def client(c: int) -> None:
        try:
            for i in range(c, LEARN_TEXTS, LEARN_CLIENTS):
                db.store(texts[i], labels=["Doc"], node_id=ids[i])
                t_store[ids[i]] = time.perf_counter()
        except Exception as e:  # re-raised on the main thread
            errs.append(e)

    def wait(n_indexed: int, deadline: float) -> None:
        while (db.storage.pending_embed_ids() or len(on_store_ms)
               < n_indexed):
            assert time.perf_counter() < deadline, (
                "the pending queue did not drain", len(
                    db.storage.pending_embed_ids()), len(on_store_ms))
            time.sleep(0.01)

    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(LEARN_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        t_stored = time.perf_counter() - t0
        if errs:
            raise errs[0]
        wait(LEARN_TEXTS, t0 + LEARN_DRAIN_S)
        t_drained = time.perf_counter() - t0
        st1 = dict(vars(worker.stats))
        launches = K.launch_counts()["streaming_topk_bf16"]
        n_first = len(on_store_ms)
        # the re-embed: the same nodes queued again through the DB's storage
        rng = np.random.default_rng(seed + 18)
        again = [ids[i] for i in rng.choice(LEARN_TEXTS, LEARN_REEMBED,
                                            replace=False)]
        t1 = time.perf_counter()
        for nid in again:
            db.storage.mark_pending_embed(nid)
        wait(LEARN_TEXTS + LEARN_REEMBED, t1 + LEARN_DRAIN_S)
        t_again = time.perf_counter() - t1
        st2 = dict(vars(worker.stats))
        launches_all = K.launch_counts()["streaming_topk_bf16"]
    finally:
        worker.on_embedded = hook
        for name in ("on_store", "process_suggestion"):
            inf.__dict__.pop(name, None)
    inf1 = dict(vars(inf.stats))
    err1 = {c: errors.labels(c).value for c in watched}
    adm = {d: admissions.labels("embed", d).value - adm0[d]
           for d in decisions}
    sheds = embedder.inner.stats.sheds_predicted - sheds0
    lag = np.array([t_indexed[i] - t_store[i] for i in ids]) * 1e3
    first_ms = np.array(on_store_ms[:n_first])
    t_last = max(t_indexed[i] for i in ids) - t0

    # -- checks: the worker's counts and the swallowed-error counters
    done = {k: st1[k] - st0[k] for k in st1}
    redo = {k: st2[k] - st1[k] for k in st2}
    log(f"[phase10] 10.8 {LEARN_TEXTS} db.store calls from {LEARN_CLIENTS} "
        f"clients in {t_stored:.2f}s ({LEARN_TEXTS / t_stored:.1f} "
        f"stores/s); queue drained {t_drained:.2f}s after the first store "
        f"(deadline {LEARN_DRAIN_S:g}s), {LEARN_TEXTS / t_last:.1f} "
        f"embeddings/s to the last node indexed; store-to-searchable p50 "
        f"{np.median(lag):.1f}ms p99 {np.percentile(lag, 99):.1f}ms; "
        f"on_store p50 {np.median(first_ms):.3f}ms p99 "
        f"{np.percentile(first_ms, 99):.3f}ms; worker {json.dumps(done)}, "
        f"re-embed of {LEARN_REEMBED} nodes {t_again:.2f}s "
        f"{json.dumps(redo)}; inference {json.dumps({k: inf1[k] - inf0[k] for k in inf1})}; "
        f"swallowed errors {json.dumps({c: err1[c] - err0[c] for c in watched})}; "
        f"the embed route's admission decisions {json.dumps(adm)}, "
        f"predicted-deadline sheds {sheds}; the model's prediction for "
        f"the same batch now "
        f"{COST_MODEL.predict('serving', 'embed', units)[0] * 1e3:.1f}ms")
    log(f"[phase10] 10.8 streaming_topk_bf16 launches: {launches} in the "
        f"stores' on_store lookups, {launches_all - launches} in the "
        f"re-embeds'")
    assert done["processed"] == LEARN_TEXTS, done
    assert done["failed"] == 0 and done["retries"] == 0, done
    assert redo["processed"] == LEARN_REEMBED and redo["failed"] == 0 \
        and redo["retries"] == 0, redo
    assert err1 == err0, ("swallowed errors", err0, err1)
    assert sheds == 0, ("the worker's batches were shed", sheds, adm)
    assert len(on_store_ms) == LEARN_TEXTS + LEARN_REEMBED
    assert launches > 0, "on_store missed the bf16 kernel"

    # -- every learned node's embedding is the embedder's for its text: bit
    # for bit while the CachedEmbedder still holds the text; a text its LRU
    # evicted is embedded again in another pack, within EMBED_COS
    nodes = db.storage.batch_get_nodes(ids)
    assert [n.id for n in nodes] == ids
    cached = np.array([embedder._key(t) in embedder._cache for t in texts])
    got = np.stack([n.embedding for n in nodes])
    again_retry = _Backoff()
    want = np.stack([v for i in range(0, LEARN_TEXTS, 256)
                     for v in again_retry(embedder.embed_batch,
                                          texts[i:i + 256])])
    exact = (got == want).all(axis=1)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    chunked = sum(1 for n in nodes if n.chunk_embeddings)
    assert not chunked and exact[cached].all(), (
        "learned embeddings", chunked, int(exact[cached].sum()))
    assert cos.min() >= EMBED_COS, ("learned embeddings", cos.min())
    same = int(exact.sum())

    # -- recall of learned texts through the DB
    t1 = time.perf_counter()
    picks = rng.choice(LEARN_TEXTS, LEARN_RECALLS, replace=False)
    hits, touched = 0, {}
    for i in picks:
        got = [r["id"] for r in db.recall(texts[i], limit=10)]
        hits += ids[i] in got
        for nid in got:  # recall touches each hit once
            touched[nid] = touched.get(nid, 0) + 1
    t_recall = time.perf_counter() - t1

    # -- the inferred edges: cosine on the card, confidence the mean
    sim = [e for e in db.storage.all_edges() if e.type == "SIMILAR_TO"]
    assert {e.id for e in sim} == set(created), (
        "SIMILAR_TO edges not made by the loop", len(sim), len(created))
    ends = sorted({x for e in sim for x in (e.start_node, e.end_node)})
    where = {x: i for i, x in enumerate(ends)}
    if sim:
        vec = torch.from_numpy(np.stack([
            n.embedding for n in db.storage.batch_get_nodes(ends)])).cuda()
        vec = vec / vec.norm(dim=1, keepdim=True)
        a = torch.tensor([where[e.start_node] for e in sim], device="cuda")
        b = torch.tensor([where[e.end_node] for e in sim], device="cuda")
        cos_e = (vec[a] * vec[b]).sum(1).cpu().numpy()
        del vec
    else:
        cos_e = np.zeros(0, np.float32)
    bad_conf = [e.id for e in sim
                if e.confidence != round(float(np.mean(created[e.id][3])), 4)
                or len(created[e.id][3]) != e.properties["evidence_count"]]
    log(f"[phase10] 10.8 recall of {LEARN_RECALLS} learned texts: "
        f"{hits}/{LEARN_RECALLS} in the top 10 ({t_recall:.2f}s); "
        f"embeddings: {same}/{LEARN_TEXTS} bit for bit the embedder's "
        f"({int(cached.sum())} still in its cache, the rest embedded again: "
        f"min cosine {float(cos.min()):.6f}), {chunked} chunked; SIMILAR_TO edges {len(sim)} (driven by the "
        f"re-embed of {LEARN_REEMBED} nodes through db.storage."
        f"mark_pending_embed), float32 cosine on the card min "
        f"{float(cos_e.min()) if len(cos_e) else float('nan'):.6f} against "
        f"the threshold {thr}, confidences the mean of their "
        f"{sum(len(c[3]) for c in created.values())} observations "
        f"(mismatches {len(bad_conf)}); " + cluster_report(fired, t0))
    assert hits >= 0.99 * LEARN_RECALLS, ("learned recall", hits)
    assert sim, "no pair reached an edge"
    assert float(cos_e.min()) >= thr - SIM_TOL, ("edge cosine", cos_e.min())
    assert not bad_conf, ("edge confidence", bad_conf[:5])
    return {"ids": ids, "texts": texts, "fired": fired, "t0": t0,
            "touched": touched,
            "edges": {e.id: [e.start_node, e.end_node, e.type, e.confidence]
                      for e in sim}}


def check_temporal(tracker, touched: dict) -> None:
    """Phase 10's ``DB.temporal``, read before 10.8: its tracker's access
    count of every node equals the touches of 10.8's recalls (the only
    touches since; a node's count is its history ring's length, at most
    ``history_size``), and it knows no other node."""
    cap = tracker.config.history_size
    tracked = set(tracker._history)
    assert tracked == set(touched), (len(tracked), len(touched))
    wrong = [n for n, k in touched.items()
             if tracker.access_count(n) != min(k, cap)]
    assert not wrong, [(n, touched[n], tracker.access_count(n))
                       for n in wrong[:5]]
    capped = sum(k > cap for k in touched.values())
    log(f"[phase10] 10.8 temporal: DB.temporal read before it; its "
        f"tracker's access counts equal the {sum(touched.values())} touches "
        f"of the recalls on {len(touched)} nodes ({capped} past the "
        f"{cap}-access history); {len(tracker.co_access_pairs(2))} "
        f"co-accessed pairs seen twice or more")


def write_checkpoint(d: str, cfg, params, tok) -> None:
    """An assistant checkpoint directory as the JAX package's
    ``train_assistant`` writes it: config.json, model.safetensors,
    vocab.json."""
    from nornicdb_tpu_torch.models import weights

    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"kind": "qwen2", "vocab_size": cfg.vocab_size,
                   "hidden": cfg.hidden, "layers": cfg.layers,
                   "heads": cfg.heads, "kv_heads": cfg.kv_heads,
                   "intermediate": cfg.intermediate,
                   "max_positions": cfg.max_positions,
                   "rope_theta": cfg.rope_theta, "trained_seq_len": 0}, f)
    weights.save_params(os.path.join(d, "model.safetensors"), params)
    tok.save(os.path.join(d, "vocab.json"))


def mount_checkpoint(db, seed: int, texts: list, gcfg):
    """Phase 9.1: a QWEN25_05B checkpoint (weights from ``seed``, a
    VocabTokenizer over ``texts`` and the GraphRAG prompt header) written
    to a temporary directory and mounted as a JAX user mounts it:
    ``NORNICDB_ASSISTANT_MODEL=<dir>`` and ``genserve.configure(gcfg)``,
    then ``db.heimdall`` (``load_generator`` on the card, then
    ``_wire_genserve``: a GenerationEngine and an EngineGenerator). Every
    tensor the engine serves is the written one bit for bit. Returns the
    EngineGenerator."""
    import tempfile

    import torch

    from nornicdb_tpu_torch import genserve
    from nornicdb_tpu_torch.genserve.graphrag import _PROMPT_HEADER
    from nornicdb_tpu_torch.heimdall import EngineGenerator
    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.models import weights
    from nornicdb_tpu_torch.models.pretrain import VocabTokenizer

    cfg = Q.QWEN25_05B
    params = Q.init_params(cfg, seed, "cuda")
    t0 = time.perf_counter()
    tok = VocabTokenizer.from_corpus(texts + [_PROMPT_HEADER],
                                     max_vocab=cfg.vocab_size)
    t_vocab = time.perf_counter() - t0
    genserve.configure(gcfg)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_checkpoint(d, cfg, params, tok)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
        os.environ["NORNICDB_ASSISTANT_MODEL"] = d
        try:
            t0 = time.perf_counter()
            gen = db.heimdall.generator
            sync()
            t_load = time.perf_counter() - t0
        finally:
            del os.environ["NORNICDB_ASSISTANT_MODEL"]
    assert isinstance(gen, EngineGenerator), type(gen)
    assert gen.engine is db.genserve_engine()
    assert gen.engine.config is gcfg and gen.engine.device.type == "cuda"
    saved, loaded = weights.flatten_params(params), weights.flatten_params(
        gen.params)
    assert list(loaded) == list(saved), "checkpoint names"
    for name, want in saved.items():
        got = loaded[name]
        assert got.dtype == want.dtype and got.is_cuda, name
        if want.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want), ("not bit for bit", name)
    del params, saved, loaded
    log(f"[phase9] checkpoint: vocabulary {tok.vocab_size} words in "
        f"{t_vocab:.1f}s; model.safetensors {size / 1e9:.3f} GB written in "
        f"{t_write:.2f}s (with config.json and vocab.json); "
        f"NORNICDB_ASSISTANT_MODEL -> db.heimdall (load_generator on "
        f"{gen.engine.device}, GenerationEngine, EngineGenerator) "
        f"{t_load:.2f}s, {len(weights.flatten_params(gen.params))} tensors "
        "bit for bit")
    return gen


def ivf_dispatches() -> float:
    """IVF-pruned searches so far: the count of the device-program
    histogram's (search, ivf) cells in the port's registry."""
    from nornicdb_tpu_torch.telemetry import REGISTRY

    return sample_total(parse_exposition(REGISTRY.render_prometheus()),
                        "nornicdb_device_program_seconds", "_count",
                        subsystem="search", kind="ivf")


def drive_chats(db, questions: list, retry) -> list:
    """CHAT_CLIENTS clients ask ``db.heimdall.chat`` the ``questions``
    (CHAT_TOKENS new tokens at most each); errors re-raised."""
    out: list = [None] * len(questions)
    errors: list = []

    def client(c: int) -> None:
        try:
            for i in range(c, len(questions), CHAT_CLIENTS):
                out[i] = retry(db.heimdall.chat,
                               [{"role": "user", "content": questions[i]}],
                               max_tokens=CHAT_TOKENS)
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CHAT_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "chat client hung"
    return out


def template_answer() -> str:
    """Phase 9.5: with no checkpoint mounted, ``db.heimdall`` of a DB on
    the card answers from the TemplateGenerator (Heimdall's prompt holds
    the example "how many nodes are there?", so the template reports the
    node count)."""
    from nornicdb_tpu_torch import open_db
    from nornicdb_tpu_torch.heimdall import TemplateGenerator

    assert "NORNICDB_ASSISTANT_MODEL" not in os.environ
    db = open_db("")
    try:
        for i in range(3):
            db.store(f"template probe {i}")
        mgr = db.heimdall
        assert isinstance(mgr.generator, TemplateGenerator)
        assert db.genserve_engine() is None
        text = mgr.chat([{"role": "user", "content": "hello"}])[
            "choices"][0]["message"]["content"]
        assert text == "The graph currently holds 3 nodes.", text
        return text
    finally:
        db.close()


def phase_rag(K, seed: int, served: dict, hybrid: dict) -> dict:
    """Phase 9, through the port's DB: the checkpoint of
    ``mount_checkpoint`` behind ``db.heimdall`` (an EngineGenerator over the
    DB's GenerationEngine); ``db.graphrag()`` answers RAG_QUESTIONS stored
    phase-8 texts from RAG_CLIENTS clients, retrieving with ``DB.recall``
    (phase 10's hybrid search, which embeds with phase 8's engine); then
    CHATS ``db.heimdall.chat`` completions from CHAT_CLIENTS clients, and a
    TemplateGenerator answer on a DB with no checkpoint. Returns the
    launches of #2 and #5 in the GraphRAG traffic."""
    import torch

    from nornicdb_tpu_torch import genserve
    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.telemetry import REGISTRY

    texts = served["texts"]
    db = hybrid["db"]
    # -- 9.2 the engine behind Heimdall's generator, and the graph
    gcfg = GenServeConfig(max_seq_tokens=RAG_SEQ_TOKENS,
                          pool_pages=8 * RAG_SEQ_TOKENS // 16 + 1)
    egen = mount_checkpoint(db, seed, texts, gcfg)
    cfg, tok = egen.cfg, egen.tokenizer
    eng = egen.engine
    # a question the serving engines shed (the retrieval's embed or the
    # generation's submit) is asked again with backoff, as a client of the
    # HTTP edge would
    retry = _Backoff()
    served_on = False
    try:
        t0 = time.perf_counter()
        eng.warmup()
        sync()
        t_warm = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 9)
        storage, svc = db.storage, db.search
        rag = db.graphrag()
        assert rag._resolve_engine() is eng and rag.config is gcfg
        log(f"[phase9] engine warmup {t_warm:.1f}s; graph "
            f"{storage.edge_count()} edges over {storage.node_count()} "
            f"nodes (phase 10's DB); db.graphrag() recalls with DB.recall")
        # the prompts the engine is given, with their handles, for the
        # dense check and the chats' token counts below
        submitted: list = []
        mu = threading.Lock()
        submit = eng.submit

        def recording_submit(prompt_ids, max_new_tokens=64,
                             deadline_ms=None):
            h = submit(prompt_ids, max_new_tokens, deadline_ms)
            with mu:
                submitted.append((list(prompt_ids), max_new_tokens, h))
            return h

        eng.submit = recording_submit

        # -- 9.3 the traffic
        rows = rng.choice(len(texts), size=RAG_QUESTIONS, replace=False)
        answers: list = [None] * RAG_QUESTIONS
        lat = np.zeros(RAG_QUESTIONS)
        errors: list = []

        def client(t: int) -> None:
            try:
                for i in range(t, RAG_QUESTIONS, RAG_CLIENTS):
                    t1 = time.perf_counter()
                    answers[i] = retry(rag.answer, texts[rows[i]])
                    lat[i] = time.perf_counter() - t1
            except Exception as e:  # re-raised on the main thread
                errors.append(e)

        torch.cuda.reset_peak_memory_stats()
        gen0 = svc._generation
        epoch0 = svc.corpus().stats()["epoch"]
        ivf0 = ivf_dispatches()
        K.reset_launch_counts()
        st0 = dataclasses.replace(eng.stats)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(RAG_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        ivf = ivf_dispatches() - ivf0
        peak = torch.cuda.max_memory_allocated()
        if errors:
            raise errors[0]
        assert not any(th.is_alive() for th in threads), "client thread hung"
        st = eng.stats
        tune = svc._tune_state
        gen_tokens = sum(a["generated_tokens"] for a in answers)
        reused = [a["prefix_reused_tokens"] for a in answers]
        retrieve = [a["timings_ms"]["retrieve"] for a in answers]
        prompt_len = [len(p) for p, _, _ in submitted]
        log(f"[phase9] {RAG_QUESTIONS} GraphRAG answers from {RAG_CLIENTS} "
            f"clients in {wall:.3f}s: answer p50={np.median(lat) * 1e3:.1f}ms "
            f"p99={np.percentile(lat, 99) * 1e3:.1f}ms retrieve "
            f"p50={np.median(retrieve):.2f}ms; {gen_tokens} tokens "
            f"tok/s={gen_tokens / wall:.1f}; prompt tokens min/p50/max "
            f"{min(prompt_len)}/{int(np.median(prompt_len))}/"
            f"{max(prompt_len)}; "
            f"prefix hits={st.prefix_hits - st0.prefix_hits} reused tokens by "
            f"answer {reused}; fused steps={st.fused_steps - st0.fused_steps} "
            f"evictions={st.evictions - st0.evictions} max_memory_allocated="
            f"{peak / 2**30:.3f}GiB; predicted-deadline sheds of the "
            f"generation engine {st.sheds_predicted - st0.sheds_predicted}, "
            f"questions asked again {retry.sheds}")
        log(f"[phase9] launches in the traffic: streaming_topk_bf16="
            f"{counts['streaming_topk_bf16']} ragged_paged_attention="
            f"{counts['ragged_paged_attention']}; IVF-pruned retrievals "
            f"{ivf:.0f} (the serving plan: "
            f"{json.dumps(tune.as_dict() if tune else None)}; "
            + cluster_report(hybrid["learned"]["fired"],
                             hybrid["learned"]["t0"])
            + f"); retrieve p99="
            f"{np.percentile(retrieve, 99):.2f}ms; the recalls' touches left "
            f"the search generation ({svc._generation}) and corpus epoch "
            f"as they were")
        assert svc._generation == gen0, "a recall's touch re-indexed"
        assert svc.corpus().stats()["epoch"] == epoch0
        # a request the engine shed after its submit (past its deadline on
        # a slow host, or for pages) was asked again: one submit more each
        shed_late = ((st.sheds_deadline - st0.sheds_deadline)
                     + (st.sheds_pool - st0.sheds_pool))
        assert len(submitted) == RAG_QUESTIONS + shed_late, (
            len(submitted), shed_late)
        submitted = [s for s in submitted if not s[2].shed]
        assert len(submitted) == RAG_QUESTIONS
        for i, a in enumerate(answers):
            assert a["mode"] == "paged", a["mode"]
            assert f"t{rows[i]}" in [src["id"] for src in a["sources"]], (
                "own node not retrieved", i)
            assert 1 <= a["generated_tokens"] <= gcfg.rag_max_new_tokens, a
            if i >= RAG_CLIENTS:  # after the first wave: header cached
                assert a["prefix_reused_tokens"] > 0, ("no prefix reuse", i)
        assert counts["streaming_topk_bf16"] > 0, "retrieval missed #2"
        # the DB's search runs with tune_enabled=False (phase 10): the
        # debounced recluster fired by 10.8's burst installs no IVF plan,
        # so no retrieval is served pruned, whenever it lands
        assert ivf == 0 and tune is None, (
            "retrieval served an IVF plan", ivf,
            tune.as_dict() if tune else None)
        assert counts["ragged_paged_attention"] > 0, "generation missed #5"

        # -- 9.4 tokens of the first answers against the dense path, and a QC
        # batch through the generator
        t0 = time.perf_counter()
        limit = gcfg.max_seq_tokens
        width = Q.pages_for(limit, gcfg.page_size) * gcfg.page_size
        equal = n_tok = 0
        for prompt, max_new, h in submitted[:RAG_CHECKED]:
            prompt = prompt[-(limit - 1):]  # the engine's own bound
            max_new = max(1, min(int(max_new), limit - len(prompt)))
            same, _ = dense_agreement(Q, egen.params, cfg, prompt, h.tokens,
                                      max_new, tok.eos_id, width)
            equal += same
            n_tok += len(h.tokens)
        qc = db.heimdall.generate_many([texts[r] for r in rows[:8]],
                                       max_tokens=16)
        log(f"[phase9] dense reference: {n_tok} tokens of {RAG_CHECKED} "
            f"answers checked, {equal} equal to its argmax; QC batch of "
            f"{len(qc)} through db.heimdall.generate_many; "
            f"{time.perf_counter() - t0:.1f}s")
        assert len(qc) == 8 and eng.stats.completed == (
            st0.completed + RAG_QUESTIONS + 8), eng.stats.as_dict()

        # -- 9.5 Heimdall chat completions through the engine, and the
        # template answer of a DB with no checkpoint
        questions = [f"what do you know about {two_words(texts[r])} ?"
                     for r in rows[:CHATS]]
        n_sub = len(submitted)
        mgr = db.heimdall
        chats0 = mgr.metrics_registry.get("chat_requests")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        chats = drive_chats(db, questions, retry)
        t_chat = time.perf_counter() - t0
        chat_launches = K.launch_counts()["ragged_paged_attention"]
        handles = [h for _, _, h in submitted[n_sub:]]
        new_tokens = [len(h.tokens) for h in handles]
        actions = [c.get("action_result") for c in chats]
        template = template_answer()
        # the heimdall families, as the JAX HTTP server registers them
        # (server/http.py: families_callback("heimdall", ...)); phase 13
        # parses them
        REGISTRY.families_callback(
            "heimdall", mgr.metrics_registry.prometheus_families)
        log(f"[phase9] {CHATS} db.heimdall.chat completions from "
            f"{CHAT_CLIENTS} clients in {t_chat:.2f}s: new tokens "
            f"{new_tokens}, ragged_paged_attention launches "
            f"{chat_launches}, finish reasons "
            f"{sorted({c['choices'][0]['finish_reason'] for c in chats})}, "
            f"actions parsed {sum(a is not None for a in actions)} (random "
            f"weights: 11d holds the status action of a trained "
            f"checkpoint); named metrics "
            f"{json.dumps(mgr.metrics_registry.snapshot())}; template answer "
            f"of a DB with no checkpoint: {template!r}")
        assert len(handles) == CHATS and all(
            1 <= n <= CHAT_TOKENS for n in new_tokens), new_tokens
        assert all(h.done for h in handles)
        assert chat_launches > 0, "the chats missed #5"
        assert mgr.metrics_registry.get("chat_requests") == chats0 + CHATS
        served_on = True
        return {"streaming_topk_bf16": counts["streaming_topk_bf16"],
                "ragged_paged_attention": counts["ragged_paged_attention"]}
    finally:
        GEN_COUNTED["9"] = eng.stats.generated_tokens
        PREDICTED_SHEDS["9"] = (eng.stats.sheds_predicted, retry.sheds)
        if not served_on:
            # on success the engine goes on serving phase 17's GraphRAG
            # route; db.close() stops it
            eng.stop()
            genserve.configure(None)


def train_flops(cfg, rows: int, t: int, tokens: int) -> float:
    """Model FLOPs of one train step: 6 x the parameters used in products
    (every block weight; the tied logits for a decoder) x tokens, plus the
    attention products (QK^T and PV, 4 B H T^2 Dh forward, twice that
    backward, over the full T x T scores the port computes)."""
    from nornicdb_tpu_torch.models import qwen2 as Q

    decoder = isinstance(cfg, Q.QwenConfig)
    h, hd = cfg.hidden, cfg.hidden // cfg.heads
    if decoder:
        kv = cfg.kv_heads * hd
        per_layer = h * h * 2 + h * kv * 2 + 3 * h * cfg.intermediate
        n = cfg.layers * per_layer + cfg.vocab_size * h
    else:
        per_layer = 4 * h * h + 2 * h * cfg.intermediate
        n = cfg.layers * per_layer + (h * cfg.dims if cfg.dims != h else 0)
    attn = 12 * cfg.layers * rows * cfg.heads * t * t * hd
    return 6.0 * n * tokens + attn


def state_on_card(state) -> int:
    """Assert every parameter and optimizer-state tensor lies on the card;
    returns the count of state tensors."""
    from nornicdb_tpu_torch.models import training as TT

    leaves = TT.param_leaves(state.params)
    assert all(p.is_cuda for p in leaves), "a parameter off the card"
    assert len(state.opt_state.state) == len(leaves), "leaf without state"
    n = 0
    for slot in state.opt_state.state.values():
        for t in slot.values():
            assert t.is_cuda, ("optimizer state off the card", t.device)
            n += 1
    return n


def first_step_vs_f32(loss_fn, params, cfg, batch) -> dict:
    """The first step's loss and gradients of the bf16 model against the
    same on a float32 copy of its parameters, both on the card: the loss's
    relative gap and, for each leaf, the gradients' cosine, the float32
    gradient's norm and the gap's norm, both over the largest leaf's
    float32 gradient norm."""
    import torch

    from nornicdb_tpu_torch._device import map_tree
    from nornicdb_tpu_torch.models import training as TT
    from nornicdb_tpu_torch.models import weights as W

    def grads(p, c):
        leaves = TT.param_leaves(p)
        loss = loss_fn(p, c, batch)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    names = list(W.flatten_params(params))  # param_leaves' order
    l16, g16 = grads(params, cfg)
    g16 = [g.float() for g in g16]
    p32 = map_tree(lambda t: t.detach().float().requires_grad_(True), params)
    l32, g32 = grads(p32, dataclasses.replace(cfg, dtype="float32"))
    del p32
    top = max(float(g.norm()) for g in g32)
    leaves = {name: (float((a * b).sum() / (a.norm() * b.norm())),
                     float(b.norm()) / top, float((a - b).norm()) / top)
              for name, a, b in zip(names, g16, g32)}
    del g16, g32
    torch.cuda.empty_cache()
    return {"loss_bf16": l16, "loss_f32": l32,
            "loss_rel": abs(l16 - l32) / abs(l32), "leaves": leaves}


def profile_train(tag: str, step, state, batch: dict, out_dir: str) -> None:
    """Device busy share of TRAIN_PROFILED train steps from torch.profiler:
    device time of every kernel over the host wall time, device ops a
    step, the GEMM rows' share of device time split into float32 and bf16
    (``dense`` beside a bias, the tied logits and attention are float32),
    and the top device ops. The per-op table goes to
    ``chiprun_out/profile_train_<tag>.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            state, _ = step(state, batch)
        sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    # cuBLAS's float32 GEMMs run sm80 xmma / cutlass SIMT kernels
    # ("f32f32", "sgemm"); its bf16 tensor-core GEMMs on Hopper "nvjet"
    gemm = [e for e in kernels
            if "gemm" in e.key.lower() or e.key.startswith("nvjet")]
    f32 = [e for e in gemm if "f32f32" in e.key or "sgemm" in e.key]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    f32_us = sum(e.self_device_time_total for e in f32)
    with open(os.path.join(out_dir, f"profile_train_{tag}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] train {tag}: {TRAIN_PROFILED} steps, wall "
        f"{wall * 1e3:.2f}ms; device {dev_us / 1e3:.2f}ms busy share "
        f"{dev_us / 1e6 / wall:.4f}; "
        f"{sum(e.count for e in kernels) / TRAIN_PROFILED:.1f} device ops "
        f"a step; GEMM rows {gemm_us / max(dev_us, 1e-9):.4f} of device "
        f"time (float32 {f32_us / max(dev_us, 1e-9):.4f}, bf16 "
        f"{(gemm_us - f32_us) / max(dev_us, 1e-9):.4f}); top device ops: "
        + "; ".join(f"{e.key[:60]}={e.self_device_time_total / 1e3:.3f}ms"
                    f"/{e.count}" for e in top))


def run_training(tag: str, step, state, batches: list, fixed: dict,
                 tokens: int, flops: float, profile_dir: str = "") -> dict:
    """TRAIN_WARMUP steps, TRAIN_TIMED steps timed (CUDA events at each
    step's start and its forward / backward / optimizer boundaries; the
    wall of the window by the host clock between syncs), then TRAIN_FIXED
    steps on one fixed batch. Logs tokens/s, step p50/p99, the split,
    peak memory, utilization and the losses; with ``profile_dir``, then
    traces TRAIN_PROFILED more steps (profile_train)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses = []
    for b in batches[:TRAIN_WARMUP]:
        state, loss = step(state, b)
        losses.append(loss)
    sync()
    marks: list = []

    def on_phase(_name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)

    t0 = time.perf_counter()
    for b in batches[TRAIN_WARMUP:]:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append([ev])
        state, loss = step(state, b, on_phase)
        losses.append(loss)
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fixed_losses = []
    for _ in range(TRAIN_FIXED):
        state, loss = step(state, fixed)
        fixed_losses.append(loss)
    sync()
    losses = [float(x) for x in losses]
    fixed_losses = [float(x) for x in fixed_losses]
    split = np.array([[a.elapsed_time(b) for a, b in zip(m, m[1:])]
                      for m in marks])  # (steps, 3) ms
    step_ms = split.sum(axis=1)
    n = len(marks)
    mfu = flops / (wall / n) / H100_BF16_OPS
    out = {"tokens_per_s": n * tokens / wall, "wall": wall,
           "step_p50": float(np.median(step_ms)),
           "step_p99": float(np.percentile(step_ms, 99)),
           "split_p50": np.median(split, axis=0).tolist(),
           "peak": peak, "held": held, "mfu": mfu, "flops": flops,
           "losses": losses, "fixed": fixed_losses, "state": state}
    log(f"[phase11] {tag}: {n} timed steps of {tokens} tokens in "
        f"{wall:.3f}s: tokens/s={out['tokens_per_s']:.1f} step "
        f"p50={out['step_p50']:.2f}ms p99={out['step_p99']:.2f}ms (mean "
        f"{wall / n * 1e3:.2f}ms); split p50 forward / backward / optimizer "
        f"{np.median(split[:, 0]):.2f} / "
        f"{np.median(split[:, 1]):.2f} / {np.median(split[:, 2]):.2f} ms; "
        f"max_memory_allocated={peak / 2**30:.3f}GiB ({held / 2**30:.3f}GiB "
        f"held before); model FLOPs a step {flops:.4e}, utilization "
        f"{mfu:.4f} of {H100_BF16_OPS / 1e12:.0f} TFLOP/s; loss first step "
        f"{losses[0]:.4f} last timed step {losses[-1]:.4f}; fixed batch "
        f"{fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f}")
    assert all(np.isfinite(losses + fixed_losses)), "non-finite loss"
    if profile_dir:
        profile_train(tag.split()[0], step, state, batches[-1], profile_dir)
    return out


def lm_batches(rng, cfg, n: int) -> list:
    """n batches of LM_BATCH windows of LM_WINDOW tokens of a seeded token
    stream, on the card."""
    import torch

    stream = rng.integers(0, cfg.vocab_size, size=1 << 20).astype(np.int32)
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(stream) - LM_WINDOW, size=LM_BATCH)
        wins = torch.from_numpy(np.stack(
            [stream[s:s + LM_WINDOW] for s in starts])).cuda()
        out.append({"ids": wins, "mask": torch.ones_like(wins)})
    return out


def pair_batches(rng, texts: list, tok, n: int) -> list:
    """n batches of ENC_PAIRS phase-8 texts and their ``_augment`` views,
    tokenized with ``tok`` and padded to ENC_LEN tokens, on the card."""
    import torch

    from nornicdb_tpu_torch.models import pretrain as P

    def side(docs):
        ids, masks = tok.encode_batch(docs, max_len=ENC_LEN)
        ids = [s + [tok.pad_id] * (ENC_LEN - len(s)) for s in ids]
        masks = [m + [0] * (ENC_LEN - len(m)) for m in masks]
        return (torch.tensor(ids, dtype=torch.int32).cuda(),
                torch.tensor(masks, dtype=torch.int32).cuda())

    out = []
    for _ in range(n):
        docs = [texts[i] for i in rng.integers(0, len(texts), ENC_PAIRS)]
        ids_a, mask_a = side(docs)
        ids_b, mask_b = side([P._augment(d, rng) for d in docs])
        out.append({"ids_a": ids_a, "mask_a": mask_a,
                    "ids_b": ids_b, "mask_b": mask_b})
    return out


def check_first_step(tag: str, res: dict) -> None:
    """The loss within FIRST_LOSS_RTOL; each leaf's gradient within cosine
    FIRST_GRAD_COS of the float32 copy's, or, for a leaf whose float32
    gradient norm is below SIGNAL_FLOOR of the largest leaf's (an exact
    zero, or nearly: there the cosine compares rounding noise), a gap
    below SIGNAL_FLOOR of the largest leaf's norm."""
    leaves = res["leaves"]
    signal = {n: v for n, v in leaves.items() if v[1] >= SIGNAL_FLOOR}
    quiet = {n: v for n, v in leaves.items() if v[1] < SIGNAL_FLOOR}
    worst = min(signal, key=lambda n: signal[n][0])
    log(f"[phase11] {tag} first step, bf16 against a float32 copy on the "
        f"card: loss {res['loss_bf16']:.6f} / {res['loss_f32']:.6f} "
        f"(relative gap {res['loss_rel']:.3e}, at most {FIRST_LOSS_RTOL}); "
        f"gradient cosine min {signal[worst][0]:.6f} ({worst}, norm "
        f"{signal[worst][1]:.3e} of the largest leaf's) median "
        f"{np.median([v[0] for v in signal.values()]):.6f} over "
        f"{len(signal)} leaves (at least {FIRST_GRAD_COS}); {len(quiet)} "
        f"leaves below {SIGNAL_FLOOR} of the largest norm"
        + (f" ({', '.join(sorted(quiet)[:6])}{', ...' if len(quiet) > 6 else ''}"
           f"; norm max {max(v[1] for v in quiet.values()):.3e}, gap max "
           f"{max(v[2] for v in quiet.values()):.3e}, cosine min "
           f"{min(v[0] for v in quiet.values()):.4f})" if quiet else ""))
    assert res["loss_rel"] <= FIRST_LOSS_RTOL, (tag, res["loss_rel"])
    assert signal[worst][0] >= FIRST_GRAD_COS, (tag, worst, signal[worst])
    assert all(v[2] <= SIGNAL_FLOOR for v in quiet.values()), quiet


def phase_train_lm(seed: int, profile_dir: str) -> None:
    """Phase 11a: QWEN25_05B at full width, LM train steps."""
    import torch

    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.models import training as TT

    cfg = Q.QWEN25_05B
    t0 = time.perf_counter()
    opt = TT.make_optimizer(lr=LM_LR)
    state = TT.init_lm_train_state(cfg, opt, seed=seed)
    n_params = sum(p.numel() for p in TT.param_leaves(state.params))
    step = TT.make_lm_train_step(cfg, opt)
    rng = np.random.default_rng(seed + 11)
    batches = lm_batches(rng, cfg, TRAIN_WARMUP + TRAIN_TIMED + 1)
    fixed = batches.pop()
    sync()
    log(f"[phase11] 11a QWEN25_05B bf16: {n_params} parameters from seed "
        f"{seed}, {len(batches)} batches of {LM_BATCH} x {LM_WINDOW} tokens "
        f"in {time.perf_counter() - t0:.1f}s")
    # every leaf, final_norm's 896 scales included (phase 5's count of
    # 494,031,872 leaves them out)
    assert n_params == 494_032_768, n_params
    check_first_step("11a", first_step_vs_f32(TT.lm_loss, state.params, cfg,
                                              batches[0]))
    tokens = LM_BATCH * (LM_WINDOW - 1)
    res = run_training("11a QWEN25_05B LM", step, state, batches, fixed,
                       tokens, train_flops(cfg, LM_BATCH, LM_WINDOW - 1,
                                           tokens), profile_dir)
    n_state = state_on_card(res["state"])
    log(f"[phase11] 11a {n_params} parameters and {n_state} optimizer-state "
        f"tensors on the card; fixed-batch drop "
        f"{res['fixed'][0] - res['fixed'][-1]:.4f} (at least {LM_FIXED_DROP})")
    assert res["fixed"][0] - res["fixed"][-1] >= LM_FIXED_DROP, res["fixed"]
    del state, res, batches, fixed
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_encoder(seed: int, texts: list, profile_dir: str) -> dict:
    """Phase 11b: BGE_M3 at full width, InfoNCE train steps over phase 8's
    texts. Returns the trained parameters and config for 11c."""
    from nornicdb_tpu_torch.models import bge_m3 as B
    from nornicdb_tpu_torch.models import training as TT
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

    cfg = B.BGE_M3
    t0 = time.perf_counter()
    opt = TT.make_optimizer(lr=ENC_LR)
    state = TT.init_train_state(cfg, opt, seed=seed)
    n_params = sum(p.numel() for p in TT.param_leaves(state.params))
    step = TT.make_train_step(cfg, opt)
    rng = np.random.default_rng(seed + 12)
    batches = pair_batches(rng, texts, HashTokenizer(cfg.vocab_size),
                           TRAIN_WARMUP + TRAIN_TIMED + 1)
    fixed = batches.pop()
    sync()
    log(f"[phase11] 11b BGE_M3 bf16: {n_params} parameters from seed {seed},"
        f" {len(batches)} batches of {ENC_PAIRS} pairs x {ENC_LEN} tokens in "
        f"{time.perf_counter() - t0:.1f}s")
    assert n_params == 566_705_152, n_params
    check_first_step("11b", first_step_vs_f32(TT.embedder_loss, state.params,
                                              cfg, batches[0]))
    tokens = 2 * ENC_PAIRS * ENC_LEN
    res = run_training("11b BGE_M3 InfoNCE", step, state, batches, fixed,
                       tokens, train_flops(cfg, 2 * ENC_PAIRS, ENC_LEN,
                                           tokens), profile_dir)
    n_state = state_on_card(res["state"])
    ratio = res["fixed"][-1] / res["fixed"][0]
    log(f"[phase11] 11b {n_params} parameters and {n_state} optimizer-state "
        f"tensors on the card; fixed-batch loss ratio last / first "
        f"{ratio:.4f} (at most {ENC_FIXED_RATIO}); losses of the 23 steps "
        + " ".join(f"{x:.4f}" for x in res["losses"]))
    assert ratio <= ENC_FIXED_RATIO, res["fixed"]
    return {"params": res["state"].params, "cfg": cfg}


def phase_distill(trained: dict, texts: list, phase8_rate: float,
                  work: str) -> None:
    """Phase 11c: 11b's encoder written as a teacher checkpoint in
    train_encoder's layout, distilled into a DISTILL_LAYERS student, the
    student mounted, gated and served."""
    import torch

    from nornicdb_tpu_torch.config import ServingConfig
    from nornicdb_tpu_torch.errors import StudentGateError
    from nornicdb_tpu_torch.models import pretrain as P
    from nornicdb_tpu_torch.models import weights as W
    from nornicdb_tpu_torch.serving import ServingEngine, gate_student

    # -- 11c.1 the teacher: train_encoder's layout, the vocabulary of a
    # VocabTokenizer over phase 8's texts (the table cut to its padded
    # size) and positions for ENC_LEN tokens
    t0 = time.perf_counter()
    tok = P.VocabTokenizer.from_corpus(texts)
    cfg = dataclasses.replace(
        trained["cfg"], vocab_size=((tok.vocab_size + 63) // 64) * 64,
        max_positions=ENC_LEN + 8, pad_token_id=tok.pad_id)
    params = dict(trained["params"])
    params["tok_emb"] = params["tok_emb"][:cfg.vocab_size]
    params["pos_emb"] = params["pos_emb"][:cfg.max_positions]
    teacher = os.path.join(work, "teacher")
    os.makedirs(teacher)
    W.save_params(os.path.join(teacher, "model.safetensors"), params)
    tok.save(os.path.join(teacher, "vocab.json"))
    with open(os.path.join(teacher, "config.json"), "w") as f:
        json.dump({"kind": "bge", **{k: getattr(cfg, k) for k in (
            "vocab_size", "hidden", "layers", "heads", "intermediate",
            "max_positions", "dims", "pad_token_id")}}, f)
    t_write = time.perf_counter() - t0
    del params, trained
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11c.2 distill, mount, gate
    t0 = time.perf_counter()
    student_dir = os.path.join(work, "student")
    stats = P.distill_encoder(teacher, student_dir, layers=DISTILL_LAYERS,
                              steps=DISTILL_STEPS,
                              corpus=texts[:DISTILL_CORPUS])
    t_distill = time.perf_counter() - t0
    t0 = time.perf_counter()
    student = P.load_embedder(student_dir)
    sync()
    t_load = time.perf_counter() - t0
    n_student = sum(t.numel() for t in W.flatten_params(
        student.params).values())
    report = gate_student(student, 0.0)
    mrr = report.metrics.mrr
    gate_student(student, max(0.0, mrr - 0.1))
    try:
        gate_student(student, mrr + 0.1)
        raise AssertionError("a threshold above the MRR admitted the student")
    except StudentGateError:
        pass
    log(f"[phase11] 11c teacher ({cfg.layers} layers, vocab "
        f"{cfg.vocab_size}, max_positions {cfg.max_positions}) written in "
        f"{t_write:.2f}s; distill_encoder(layers={DISTILL_LAYERS}, "
        f"steps={DISTILL_STEPS}) over {DISTILL_CORPUS} texts in "
        f"{t_distill:.2f}s: loss {stats['loss_first']:.4f} -> "
        f"{stats['loss_last']:.4f}, agreement {stats['agreement']:.4f}; "
        f"student ({student.cfg.layers} layers, hidden {student.cfg.hidden},"
        f" intermediate {student.cfg.intermediate}, {n_student} parameters) "
        f"loaded in {t_load:.2f}s on {student.device}; builtin-suite MRR "
        f"{mrr:.4f}: admitted at {max(0.0, mrr - 0.1):.4f}, rejected at "
        f"{mrr + 0.1:.4f}")
    assert student.device.type == "cuda"
    assert stats["student_layers"] == DISTILL_LAYERS
    assert np.isfinite([stats["loss_first"], stats["loss_last"],
                        stats["agreement"]]).all()

    # -- 11c.3 the student behind ServingEngine
    # the process-wide cost model keys the embed path by (serving, embed),
    # not by model: it comes here with what phases 8 and 10 taught it about
    # the 24-layer encoder, and sheds at submit until the student's packs
    # teach it otherwise (half-open probes admit every 8th); the clients
    # retry with backoff, as a client of the HTTP edge would
    eng = ServingEngine(student, ServingConfig())
    warm_retry, retry = _Backoff(), _Backoff()
    try:
        few = texts[:STUDENT_TEXTS]
        drive_embed(eng, few[:EMBED_CALL * EMBED_CLIENTS], EMBED_CLIENTS,
                    EMBED_CALL, warm_retry)  # each class the mix reaches
        run = drive_embed(eng, few, EMBED_CLIENTS, EMBED_CALL, retry)
    finally:
        eng.stop()
    PREDICTED_SHEDS["11c"] = (eng.stats.sheds_predicted,
                              warm_retry.sheds + retry.sheds)
    embs = np.stack(run["out"])
    rate = STUDENT_TEXTS / run["wall"]
    log(f"[phase11] 11c student behind ServingEngine: {STUDENT_TEXTS} "
        f"phase-8 texts from {EMBED_CLIENTS} clients in {run['wall']:.3f}s: "
        f"embeddings/s={rate:.1f} (phase 8, 24 layers, this run: "
        f"{phase8_rate:.1f}); client p50="
        f"{np.median(run['lat']) * 1e3:.2f}ms; predicted-deadline sheds "
        f"{eng.stats.sheds_predicted} (calls retried: {warm_retry.sheds} in "
        f"the warm-up, {retry.sheds} in the timed run)")
    assert embs.shape == (STUDENT_TEXTS, student.cfg.dims)
    assert np.isfinite(embs).all()
    assert np.abs(np.linalg.norm(embs, axis=1) - 1.0).max() <= 1e-3


def phase_train_cli(work: str) -> None:
    """Phase 11d: ``train assistant`` and ``train encoder`` at the JAX
    presets through the port's command line, on the card, then the learning
    checks of tests/test_pretrain.py."""
    import contextlib
    import io

    from nornicdb_tpu_torch.cli import main as cli_main
    from nornicdb_tpu_torch.models import pretrain as P

    runs = {}
    for model in ("assistant", "encoder"):
        out = os.path.join(work, model)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["train", model, "--out", out])
        secs = time.perf_counter() - t0
        assert rc == 0
        runs[model] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                       secs, out)
    stats, secs, out = runs["assistant"]
    gen = P.load_generator(out)
    correct, answers = 0, {}
    for country, capital in P._CAPITALS.items():
        ids = gen.tokenizer.encode(f"the capital of {country} is",
                                   add_special=False)
        toks = gen.qwen2.generate(gen.params, gen.cfg, ids, max_new_tokens=4,
                                  eos_id=gen.tokenizer.eos_id)
        answers[country] = gen.tokenizer.decode(toks)
        correct += capital in answers[country]
    log(f"[phase11] 11d train assistant: {stats['steps']} steps in "
        f"{secs:.2f}s ({stats['steps'] / secs:.1f} steps/s), loss "
        f"{stats['loss_first']:.4f} -> {stats['loss_last']:.4f}; capitals "
        f"{correct}/{len(P._CAPITALS)} on {gen.device}")
    assert gen.device.type == "cuda"
    assert stats["loss_last"] < 0.3 * stats["loss_first"], stats
    assert correct >= 8, answers
    del gen
    status_action(out)
    stats, secs, out = runs["encoder"]
    emb = P.load_embedder(out)
    docs = ["the capital of norway is oslo.",
            "match finds nodes and return sends them back.",
            "memory decay lowers the score of unused memories over time."]
    queries = ["capital norway oslo", "match return nodes",
               "decay unused memories"]
    top1 = (np.stack(emb.embed_batch(queries))
            @ np.stack(emb.embed_batch(docs)).T).argmax(axis=1)
    hits = int((top1 == np.arange(3)).sum())
    log(f"[phase11] 11d train encoder: {stats['steps']} steps in "
        f"{secs:.2f}s ({stats['steps'] / secs:.1f} steps/s), loss "
        f"{stats['loss_first']:.4f} -> {stats['loss_last']:.4f}; top-1 "
        f"right for {hits}/3 queries on {emb.device}")
    assert emb.device.type == "cuda"
    assert stats["loss_last"] < stats["loss_first"], stats
    assert hits >= 2, top1


def status_action(model_dir: str) -> None:
    """11d: the trained assistant (whose corpus holds the action mode's
    status prompts in Heimdall's served form) mounted in a DB on the card
    as a JAX user mounts it (``NORNICDB_ASSISTANT_MODEL``): the trained
    status prompts go through ``db.heimdall.chat`` (the paged engine,
    kernel #5); at least one must parse to the ``status`` action, whose
    dispatch returns the DB's node and edge counts."""
    from nornicdb_tpu_torch import open_db
    from nornicdb_tpu_torch.heimdall import EngineGenerator
    from nornicdb_tpu_torch.models import pretrain as P
    from nornicdb_tpu_torch.ops import kernels as K

    os.environ["NORNICDB_ASSISTANT_MODEL"] = model_dir
    db = open_db("")
    try:
        a = db.store("the capital of norway is oslo")
        b = db.store("oslo is a city in norway")
        db.store("bergen is a city in norway")
        db.link(a.id, b.id, "ABOUT")
        mgr = db.heimdall
        assert isinstance(mgr.generator, EngineGenerator)
        want = {"status": "ok", "nodes": 3, "edges": 1}
        prompts = P._STATUS_PROMPTS[:-1]  # the last one is held out
        r0 = K.launch_counts()["ragged_paged_attention"]
        t0 = time.perf_counter()
        replies = [mgr.chat([{"role": "user", "content": p}], max_tokens=32)
                   for p in prompts]
        secs = time.perf_counter() - t0
        launches = K.launch_counts()["ragged_paged_attention"] - r0
        results = [r.get("action_result") for r in replies]
        hits = sum(r == want for r in results)
        log(f"[phase11] 11d db.heimdall over the trained assistant "
            f"(EngineGenerator, max_context {mgr.generator.max_context}): "
            f"{len(prompts)} trained status prompts in {secs:.2f}s, "
            f"ragged_paged_attention launches {launches}, {hits} parsed to "
            f"the status action and returned the DB's counts {want}; "
            f"replies {[r['choices'][0]['message']['content'] for r in replies]}")
        assert launches > 0, "the chats missed #5"
        assert hits >= 1, results
    finally:
        del os.environ["NORNICDB_ASSISTANT_MODEL"]
        eng = db.genserve_engine()
        db.close()
        if eng is not None:
            GEN_COUNTED["11d"] = eng.stats.generated_tokens


def phase_train(seed: int, texts: list, phase8_rate: float,
                profile_dir: str = "") -> None:
    """Phase 11: training at full width (11a, 11b), distill + gate + serve
    (11c), the train command at its presets (11d)."""
    import tempfile

    import torch

    log(f"[phase11] held on the card before 11a: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f}GiB")
    t0 = time.perf_counter()
    phase_train_lm(seed, profile_dir)
    log(f"[phase11] 11a {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    trained = phase_train_encoder(seed, texts, profile_dir)
    log(f"[phase11] 11b {time.perf_counter() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        phase_distill(trained, texts, phase8_rate, work)
        del trained
        log(f"[phase11] 11c {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_train_cli(work)
        log(f"[phase11] 11d {time.perf_counter() - t0:.1f}s")


def pagerank_f64(src: np.ndarray, dst: np.ndarray, n: int,
                 damping: float = 0.85, iters: int = 20) -> np.ndarray:
    """The float64 reference of ``graph_algos.pagerank``: the same damped
    power iteration (dangling mass spread uniformly) with ``np.bincount``
    over the same edges."""
    # numpy indexes and bins with intp: convert once, not every iteration
    src, dst = src.astype(np.intp), dst.astype(np.intp)
    deg = np.bincount(src, minlength=n).astype(np.float64)
    safe = np.maximum(deg, 1.0)
    dangling = deg == 0
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        incoming = np.bincount(dst, weights=(rank / safe)[src], minlength=n)
        rank = (1.0 - damping) / n + damping * (
            incoming + rank[dangling].sum() / n)
    return rank


def scipy_wcc(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """scipy's weak components of the (src, dst) graph, each node labelled
    by its component's smallest member (``connected_components``' labels)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as scipy_cc

    adj = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                        shape=(n, n))
    _, comp = scipy_cc(adj, directed=False)
    _, first = np.unique(comp, return_index=True)
    return first[comp].astype(np.int32)


def pagerank_error(ranks: np.ndarray, ref: np.ndarray) -> tuple:
    """Phase 12's measures of ranks against the float64 reference: the L1
    distance and the largest relative error of the PR_TOP highest ranks."""
    l1 = float(np.abs(ranks.astype(np.float64) - ref).sum())
    top = np.argsort(-ref)[:PR_TOP]
    return l1, float(np.max(np.abs(ranks[top] - ref[top]) / ref[top]))


def phase_graph(seed: int) -> None:
    """Phase 12: the graph offloads. 12a PageRank and 12b WCC over a
    Graph500 Kronecker graph at GRAPH_SCALE, numpy in and numpy out as a
    caller passes them, held to a float64 numpy power iteration and to
    scipy's components; 12c link prediction over a port MemoryEngine of a
    LINK_SCALE Kronecker graph, on the card against the CPU path."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components as scipy_cc

    from nornicdb_tpu_torch.linkpredict import (
        batch_scores,
        build_graph,
        top_candidates,
    )
    from nornicdb_tpu_torch.ops import graph_algos as GA
    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    # -- 12a the graph, then PageRank
    n = 1 << GRAPH_SCALE
    t0 = time.perf_counter()
    s_dev, d_dev = kronecker_edges(GRAPH_SCALE, GRAPH_EDGEFACTOR, seed, "cuda")
    sync()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    src, dst = s_dev.cpu().numpy(), d_dev.cpu().numpy()
    t_host = time.perf_counter() - t0
    m = len(src)
    out_deg = np.bincount(src, minlength=n)
    in_deg = np.bincount(dst, minlength=n)
    hubs = np.argsort(-in_deg)[:PR_TOP]
    log(f"[phase12] Graph500 Kronecker SCALE {GRAPH_SCALE} edgefactor "
        f"{GRAPH_EDGEFACTOR} (A, B, C = {GRAPH500_A}, {GRAPH500_B}, "
        f"{GRAPH500_C}), seed {seed}: {n} vertices, {m} edges, "
        f"{int((src == dst).sum())} self-loops, "
        f"{int(((out_deg + in_deg) == 0).sum())} isolated vertices, max "
        f"out-degree {int(out_deg.max())} in-degree {int(in_deg.max())}, "
        f"the {PR_TOP} largest in-degrees take "
        f"{in_deg[hubs].sum() / m:.4f} of the edges; made on the card in "
        f"{t_gen:.2f}s, copied to the host in {t_host:.2f}s "
        f"({(src.nbytes + dst.nbytes) / 1e9:.3f} GB as int32)")
    assert m == GRAPH_EDGEFACTOR << GRAPH_SCALE and src.dtype == np.int32

    GA.pagerank(src, dst, n)  # warm-up
    e2e, runs = [], []
    for _ in range(GRAPH_CALLS):
        t0 = time.perf_counter()
        runs.append(GA.pagerank(src, dst, n))  # device=None: the card
        e2e.append(time.perf_counter() - t0)
    ranks = runs[-1]
    iters = 20
    dev_ms = cuda_ms(lambda: GA.pagerank_device(s_dev, d_dev, n),
                     GRAPH_CALLS)
    setup_ms = cuda_ms(lambda: GA.pagerank_device(s_dev, d_dev, n, iters=0),
                       GRAPH_CALLS)
    iter_ms = (dev_ms - setup_ms) / iters
    copy_ms = cuda_ms(lambda: (torch.from_numpy(src).to("cuda"),
                               torch.from_numpy(dst).to("cuda")), 3)
    back_ms = cuda_ms(lambda: GA.pagerank_device(s_dev, d_dev, n,
                                                 iters=0).cpu(), 3) - setup_ms
    # per iteration the code moves: the gather kernel reads src and the
    # n-sized quotient at src and writes the contributions (3 x 4m), the
    # index_add_ reads dst and the contributions and updates incoming
    # (3 x 4m), plus five n-sized float32 vectors (the quotient, incoming
    # zeroed, the dangling sum, the new rank): 24m + 20n bytes
    bound_iter = (24 * m + 20 * n) / H100_BYTES * 1e3
    e2e_ms = float(np.median(e2e)) * 1e3
    t0 = time.perf_counter()
    ref = pagerank_f64(src, dst, n, iters=iters)
    t_ref = time.perf_counter() - t0
    l1 = float(np.abs(ranks.astype(np.float64) - ref).sum())
    top = np.argsort(-ref)[:PR_TOP]
    top_rel = float(np.max(np.abs(ranks[top] - ref[top]) / ref[top]))
    spread = max(float(np.abs(r - ranks).max()) for r in runs)
    log(f"[phase12] 12a pagerank (0.85, {iters} iterations): end to end "
        f"p50 {e2e_ms:.2f}ms (numpy in, numpy out; calls "
        f"{[round(x * 1e3, 2) for x in e2e]}), device {dev_ms:.3f}ms by "
        f"CUDA events (setup: out-degrees {setup_ms:.3f}ms), "
        f"{iter_ms:.4f}ms an iteration, "
        f"{m * iters / (dev_ms / 1e3):.4g} edges x iterations/s; bytes "
        f"bound (24m + 20n) / 3.35 TB/s = {bound_iter:.4f}ms an iteration, "
        f"share {bound_iter / iter_ms:.4f}; host-to-device copy of the "
        f"edges {copy_ms:.2f}ms and the ranks back {back_ms:.3f}ms: "
        f"{(copy_ms + back_ms) / e2e_ms:.4f} of the call; float64 numpy "
        f"reference in {t_ref:.1f}s: L1 {l1:.4e} (at most {PR_L1_TOL:g}), "
        f"largest relative error of the {PR_TOP} highest ranks "
        f"{top_rel:.4e} (at most {PR_TOP_REL_TOL:g}); sum {ranks.sum():.6f}; "
        f"largest difference between the {GRAPH_CALLS} calls {spread:.3e} "
        f"(float32 atomics in no fixed order)")
    assert ranks.shape == (n,) and ranks.dtype == np.float32
    assert np.isfinite(ranks).all()
    assert l1 <= PR_L1_TOL, ("pagerank L1", l1)
    assert top_rel <= PR_TOP_REL_TOL, ("pagerank top ranks", top_rel)

    # -- 12b WCC on the same graph
    GA.connected_components(src, dst, n)  # warm-up
    t0 = time.perf_counter()
    labels = GA.connected_components(src, dst, n)
    e2e_w = (time.perf_counter() - t0) * 1e3
    s2 = torch.cat([s_dev, d_dev])
    d2 = torch.cat([d_dev, s_dev]).to(torch.int64)
    out: list = []
    wcc_ms = cuda_ms(lambda: out.append(GA.wcc_device(s2, d2, n)), 1)
    rounds = out[-1][1]
    del s2, d2, out
    t0 = time.perf_counter()
    adj = sp.csr_matrix((np.ones(m, np.float32), (src, dst)), shape=(n, n))
    n_comp, comp = scipy_cc(adj, directed=False)
    del adj
    _, first = np.unique(comp, return_index=True)
    want = first[comp].astype(np.int32)  # each component's smallest member
    t_scipy = time.perf_counter() - t0
    sizes = np.bincount(comp)
    log(f"[phase12] 12b connected components: {rounds} rounds (the last "
        f"changed nothing), device {wcc_ms:.3f}ms ({wcc_ms / rounds:.4f}ms a "
        f"round), end to end {e2e_w:.2f}ms; {n_comp} components, the "
        f"largest {int(sizes.max())} vertices, {int((sizes == 1).sum())} "
        f"singletons; scipy in {t_scipy:.1f}s, labels equal: "
        f"{bool(np.array_equal(labels, want))}")
    assert labels.dtype == np.int32
    assert np.array_equal(labels, want), "WCC labels differ from scipy's"
    del s_dev, d_dev, src, dst, ranks, runs, ref, labels, want, comp
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12c link prediction over a port MemoryEngine
    nl = 1 << LINK_SCALE
    ls, ld = kronecker_edges(LINK_SCALE, GRAPH_EDGEFACTOR, seed + 13, "cuda")
    ls, ld = ls.cpu().numpy(), ld.cpu().numpy()
    t0 = time.perf_counter()
    storage = MemoryEngine()
    for i in range(nl):
        storage.create_node(Node(id=f"g{i}"))
    for e, (a, b) in enumerate(zip(ls.tolist(), ld.tolist())):
        storage.create_edge(Edge(id=f"k{e}", start_node=f"g{a}",
                                 end_node=f"g{b}", type="LINKS"))
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_graph(storage)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj = np.zeros((nl, nl), np.float32)  # batch_scores' own fill
    for i, nbrs in enumerate(g.neighbors):
        for j in nbrs:
            adj[i, j] = 1.0
    t_fill = time.perf_counter() - t0
    a_dev = torch.from_numpy(adj).to("cuda")
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        prod_ms = cuda_ms(lambda: torch.matmul(a_dev, a_dev), 3)
    finally:
        torch.set_float32_matmul_precision(prec)
    del a_dev, adj
    log(f"[phase12] 12c Kronecker SCALE {LINK_SCALE}: {nl} nodes and "
        f"{len(ls)} edges stored in {t_load:.2f}s; build_graph "
        f"{t_build * 1e3:.1f}ms ({sum(map(len, g.neighbors)) // 2} "
        f"undirected pairs); dense fill {t_fill * 1e3:.1f}ms; one "
        f"{nl} x {nl} float32 product on the card {prod_ms:.3f}ms "
        f"(2n^3 / 67 TFLOP/s = {2 * nl ** 3 / H100_FP32_OPS * 1e3:.3f}ms)")
    t_dev = {}
    for method in ("commonNeighbors", "jaccard", "adamicAdar",
                   "preferentialAttachment", "resourceAllocation"):
        t0 = time.perf_counter()
        got = batch_scores(g, method)  # device=None: the card
        t_dev[method] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = batch_scores(g, method, use_device=False)
        t_cpu = time.perf_counter() - t0
        diff = float(np.abs(got.astype(np.float64) - want).max())
        log(f"[phase12] 12c batch_scores {method}: card {t_dev[method]:.3f}s"
            f", numpy {t_cpu:.3f}s, max |diff| {diff:.3e}, max score "
            f"{float(want.max()):.4f}")
        if method in ("commonNeighbors", "preferentialAttachment"):
            assert np.array_equal(got, want), method
        else:
            np.testing.assert_allclose(got, want, rtol=LINK_TOL,
                                       atol=LINK_TOL, err_msg=method)
    del got, want
    t0 = time.perf_counter()
    cands = top_candidates(g, "adamicAdar", limit=LINK_LIMIT)
    t_top = time.perf_counter() - t0
    ref_c = top_candidates(g, "adamicAdar", limit=LINK_LIMIT, device="cpu")
    cut = ref_c[-1][2] * (1 + LINK_TOL) + LINK_TOL
    same = ({c[:2] for c in cands if c[2] > cut}
            == {c[:2] for c in ref_c if c[2] > cut})
    log(f"[phase12] 12c top_candidates(adamicAdar, {LINK_LIMIT}) in "
        f"{t_top:.3f}s (host top-k ~{t_top - t_dev['adamicAdar']:.3f}s "
        f"beyond batch_scores): {cands[:3]} ...; the CPU's pairs above the "
        f"last score's tie band: {same}")
    assert len(cands) == len(ref_c) == LINK_LIMIT
    assert same, ("top candidates", cands, ref_c)
    for c, r in zip(cands, ref_c):
        assert abs(c[2] - r[2]) <= LINK_TOL * (1 + abs(r[2])), (c, r)


# ---------------------------------------------------------------- phase 14
# CPU-only children (CUDA hidden, a session of their own) started once
# 10.7 has written their inputs (the crash image, the expected state, the
# crash documents): they run beside phase 9, the close and phases 11 and
# 12, and phase 14 collects them. Each prints one line a step (flushed) to
# a file.
CHILDREN: dict = {}


def crash_child(mode: str, d: str, kill_at: int) -> None:
    """14c's child: write through the chain, print a line per acknowledged
    write, SIGKILL itself before write ``kill_at``. ``async``: the default
    chain writes the CRASH_DOCS documents and their edges, flushes, prints
    the counts, then writes CRASH_LATE more in bursts of 64; ``sync``: async_writes=False,
    wal_sync=True (``NORNICDB_NATIVE_WAL=1`` set by the parent) writes up to
    CRASH_SYNC documents and prints the fsync histogram before the kill."""
    import signal

    from nornicdb_tpu_torch.storage import Edge, Node, native, open_storage
    from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

    src = os.path.join(CHAIN_DIR, "crash_docs")
    embs = np.load(os.path.join(src, "docs.npy"))
    with open(os.path.join(src, "docs.json")) as f:
        meta = json.load(f)
    texts, edges = meta["texts"], meta["edges"]

    def kill() -> None:
        torch = sys.modules.get("torch")
        log("CUDA", bool(torch is not None and torch.cuda.is_initialized()))
        os.kill(os.getpid(), signal.SIGKILL)

    def node(i: int, nid: str):
        return Node(id=nid, labels=["Doc"], properties={"content": texts[i]},
                    embedding=embs[i])

    if mode == "async":
        eng = open_storage(d)
        for i in range(len(texts)):
            eng.create_node(node(i, f"c{i}"))
        for k, (a, b) in enumerate(edges):
            eng.create_edge(Edge(id=f"ce{k}", start_node=f"c{a}",
                                 end_node=f"c{b}"))
        eng.flush()
        log("FLUSHED", eng.node_count(), eng.edge_count())
        for j in range(CRASH_LATE):
            if j == kill_at:
                kill()
            eng.create_node(node(j, f"late{j}"))
            log("ACK", j)
            if j % 64 == 63:  # a flush tick between bursts: some of the
                time.sleep(0.06)  # later writes reach the WAL, some not
    else:
        eng = open_storage(d, async_writes=False, wal_sync=True)
        lib = native._lib
        log("NATIVE", json.dumps({
            "enabled": eng.wal._use_native,
            "library": lib._name if lib else None,
            "build_dir": str(native.BUILD_DIR),
            "build_seconds": native.build_seconds.get("walcodec")}))
        for i in range(CRASH_SYNC):
            if i == kill_at:
                cell = REGISTRY._families["nornicdb_wal_fsync_seconds"].labels()
                counts, total, n = cell.snapshot()
                log("FSYNC", json.dumps({"bounds": list(cell.bounds),
                                         "counts": counts, "sum": total,
                                         "count": n}))
                kill()
            eng.create_node(node(i, f"s{i}"))
            log("ACK", i)


def replay_child(d: str) -> None:
    """14b's child: recover the crash image (no snapshot: the whole WAL is
    replayed) and hold it to phase 10's state, then compact(), close() and
    reopen once more; one JSON line per step."""
    from nornicdb_tpu_torch.multidb import DEFAULT_DB
    from nornicdb_tpu_torch.storage import NamespacedEngine, open_storage

    expect, embs = expect_state()
    assert not os.path.exists(os.path.join(d, "wal", "snapshot.json"))
    wal_bytes = os.path.getsize(os.path.join(d, "wal", "wal.log"))
    t0 = time.perf_counter()
    storage = open_storage(d)
    t_rep = time.perf_counter() - t0
    records = storage.base.wal.stats.recovered_entries
    # the DB's records live under the default database's namespace
    check_recovered(NamespacedEngine(storage, DEFAULT_DB), expect, embs,
                    "14b")
    log("REPLAYED", json.dumps({"wal_bytes": wal_bytes, "records": records,
                                "seconds": t_rep}))
    t0 = time.perf_counter()
    storage.base.compact()
    t_compact = time.perf_counter() - t0
    snap_bytes = os.path.getsize(os.path.join(d, "wal", "snapshot.json"))
    t0 = time.perf_counter()
    storage.close()  # WALEngine.close: a final compact, then the log closed
    t_close = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = open_storage(d)
    t_again = time.perf_counter() - t0
    # left open: its close would write the same snapshot once more
    log("REOPENED", json.dumps({
        "compact": t_compact, "snapshot_bytes": snap_bytes,
        "close": t_close, "reopen": t_again,
        "counts": [again.node_count(), again.edge_count()]}))


def start_children(seed: int) -> None:
    """Start 14b's replay child and 14c's two crash children (kill points
    from ``seed``); their output goes to files under CHAIN_DIR."""
    rng = np.random.default_rng(seed + 15)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    jobs = {
        "replay": ("replay_child", (os.path.join(CHAIN_DIR, "db10_crash"),)),
        "async": ("crash_child", ("async", os.path.join(CHAIN_DIR, "crash_async"),
                                  int(rng.integers(1, CRASH_LATE)))),
        "sync": ("crash_child", ("sync", os.path.join(CHAIN_DIR, "crash_sync"),
                                 int(rng.integers(CRASH_SYNC // 2, CRASH_SYNC)))),
    }
    for name, (fn, args) in jobs.items():
        out = os.path.join(CHAIN_DIR, f"child_{name}.out")
        call = f"import chip_smoke as C; C.{fn}(*{args!r})"
        with open(out, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", call], cwd=root, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(env, NORNICDB_NATIVE_WAL="1" if name == "sync"
                         else ""))
        CHILDREN[name] = (proc, out, args, time.perf_counter())

    def stop() -> None:
        for proc, *_ in CHILDREN.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)


def collect_child(name: str, rc: int, timeout: float = 900.0) -> tuple:
    """Wait for a child; its exit code must be ``rc``. Returns its complete
    output lines (a partial last line is dropped, not parsed), its
    arguments and its seconds."""
    proc, out, args, t0 = CHILDREN[name]
    proc.wait(timeout=timeout)
    seconds = time.perf_counter() - t0
    with open(out) as f:
        text = f.read()
    assert proc.returncode == rc, (name, proc.returncode, text[-3000:])
    return text.split("\n")[:-1], args, seconds


def hist_quantile(bounds: list, counts: list, q: float) -> float:
    """The ``q`` quantile of a Prometheus histogram, interpolated inside
    its bucket (``histogram_quantile``'s rule)."""
    total = sum(counts)
    want, seen, lo = q * total, 0, 0.0
    for hi, c in zip(list(bounds) + [float("inf")], counts):
        if c and seen + c >= want:
            return lo + (hi - lo) * (want - seen) / c if hi != float("inf") \
                else lo
        seen += c
        lo = hi
    return lo


def du_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def record_chain(db, cfg, texts: list, run: dict, seed: int,
                 learned: dict) -> dict:
    """Phase 10.7: after the writers and 10.8, what phase 14 holds the
    recovered chain to. The chain is flushed; the counts, the writers' ids,
    every node's content and embedding (10.8's learned nodes among them)
    and 10.8's inferred edges are saved under CHAIN_DIR (phase 14 reads
    them after phase 10's DB is closed); a fresh
    ``SearchService`` over the live chain (phase 10's config,
    ``build_indexes``) gives the row order and the answers of VEC_QUERIES
    stored embeddings, k = VEC_K; then the directory is copied while no
    write is in flight (each WAL append is written and flushed to the OS,
    ``auto_compact`` is off): the image a kill at that moment leaves. Last,
    14c's input documents are written."""
    import dataclasses as dc
    import shutil

    from nornicdb_tpu_torch.search import SearchService

    storage = db.storage
    t0 = time.perf_counter()
    storage.flush()
    nodes = list(storage.all_nodes())
    ids = [n.id for n in nodes]
    contents = [n.properties.get("content") for n in nodes]
    embs = np.stack([n.embedding for n in nodes])
    assert embs.dtype == np.float32
    del nodes
    np.save(os.path.join(CHAIN_DIR, "expect_emb.npy"), embs)
    expect = {"ids": ids, "contents": contents,
              "nodes": storage.node_count(), "edges": storage.edge_count(),
              "deleted": sorted(run["deleted"]),
              "x0": contents[ids.index("x0")],
              "learned": learned["ids"], "inferred": learned["edges"]}
    with open(os.path.join(CHAIN_DIR, "expect.json"), "w") as f:
        json.dump(expect, f)
    t_save = time.perf_counter() - t0
    # the writers' nodes deleted; x0 and the learned nodes added
    assert expect["nodes"] == len(texts) + 1 + LEARN_TEXTS
    assert not set(expect["deleted"]) & set(ids)

    t0 = time.perf_counter()
    fresh = SearchService(storage, config=dc.replace(cfg), device="cuda")
    assert fresh.build_indexes() == len(ids)
    wait_drained(fresh.corpus())
    t_fresh = time.perf_counter() - t0
    rows = list(fresh.corpus()._ids)
    rng = np.random.default_rng(seed + 14)
    queries = embs[rng.choice(len(ids), VEC_QUERIES, replace=False)]
    answers = [fresh.vector_candidates(q, k=VEC_K) for q in queries]
    fresh.shutdown()
    assert all(len(a) == VEC_K for a in answers)

    t0 = time.perf_counter()
    shutil.copytree(os.path.join(CHAIN_DIR, "db10"),
                    os.path.join(CHAIN_DIR, "db10_crash"))
    t_copy = time.perf_counter() - t0
    # 14c's input: the first CRASH_DOCS documents and seeded edges
    src = os.path.join(CHAIN_DIR, "crash_docs")
    os.makedirs(src)
    np.save(os.path.join(src, "docs.npy"), embs[:CRASH_DOCS])
    deg = rng.integers(RAG_EDGES[0], RAG_EDGES[1] + 1, CRASH_DOCS)
    a = np.repeat(np.arange(CRASH_DOCS), deg)
    edges = np.stack([a, rng.integers(0, CRASH_DOCS, a.size)], 1).tolist()
    with open(os.path.join(src, "docs.json"), "w") as f:
        json.dump({"texts": contents[:CRASH_DOCS], "edges": edges}, f)
    log(f"[phase10] 10.7 for phase 14: {expect['nodes']} nodes "
        f"({len(expect['learned'])} learned), {expect['edges']} edges "
        f"({len(expect['inferred'])} inferred), {len(expect['deleted'])} "
        f"deleted ids, "
        f"state saved in {t_save:.2f}s; a fresh SearchService over the live "
        f"chain indexed in {t_fresh:.2f}s and answered {VEC_QUERIES} "
        f"vector queries (k={VEC_K}); crash image copied in {t_copy:.2f}s "
        f"({du_bytes(os.path.join(CHAIN_DIR, 'db10_crash'))} bytes)")
    return {"rows": rows, "queries": queries, "answers": answers, "cfg": cfg}


def expect_state() -> tuple[dict, np.ndarray]:
    with open(os.path.join(CHAIN_DIR, "expect.json")) as f:
        expect = json.load(f)
    return expect, np.load(os.path.join(CHAIN_DIR, "expect_emb.npy"))


def check_recovered(storage, expect: dict, embs: np.ndarray,
                    tag: str) -> None:
    """Counts equal phase 10's; every node (the acknowledged creates and
    updates, and 10.8's learned nodes, among them) reads back with its
    content and its embedding bit for bit; every deleted id is absent;
    10.8's inferred edges come back with their ends, type and
    confidence."""
    assert storage.node_count() == expect["nodes"], (tag, "nodes")
    assert storage.edge_count() == expect["edges"], (tag, "edges")
    nodes = storage.batch_get_nodes(expect["ids"])
    assert [n.id for n in nodes] == expect["ids"], (tag, "nodes missing")
    assert [n.properties.get("content") for n in nodes] == \
        expect["contents"], (tag, "contents")
    got = np.stack([n.embedding for n in nodes])
    assert got.dtype == np.float32 and got.tobytes() == embs.tobytes(), (
        tag, "embeddings not bit for bit")
    assert storage.get_node("x0").properties["content"] == expect["x0"]
    for nid in expect["deleted"]:
        assert not storage.batch_get_nodes([nid]), (tag, "deleted", nid)
    for eid, (a, b, rel, conf) in expect["inferred"].items():
        e = storage.get_edge(eid)
        assert [e.start_node, e.end_node, e.type, e.confidence] == [
            a, b, rel, conf] and e.auto_generated, (tag, "inferred", eid)


def phase_recover(K, rec: dict) -> object:
    """14a: reopen phase 10's DB with ``open_db`` from its close-time
    snapshot, hold it to phase 10's state (10.8's learned nodes, their
    embeddings and the inferred edges among it), and serve the VEC_QUERIES
    vector queries on the card through ``db.search`` and kernel #2: row
    order, ids and scores bit for bit those of phase 10's fresh service.
    Returns the reopened DB (14d reuses its storage)."""
    import dataclasses as dc

    from nornicdb_tpu_torch import open_db

    expect, embs = expect_state()
    d = os.path.join(CHAIN_DIR, "db10")
    snap_bytes = os.path.getsize(os.path.join(d, "wal", "snapshot.json"))
    log_bytes = os.path.getsize(os.path.join(d, "wal", "wal.log"))
    t0 = time.perf_counter()
    db = open_db(d)
    t_rec = time.perf_counter() - t0
    assert db.device.type == "cuda"
    storage = db.storage
    check_recovered(storage, expect, embs, "14a")
    assert not storage.pending_embed_ids(), "learned nodes left pending"
    t0 = time.perf_counter()
    svc = db.search
    assert dc.asdict(svc.config) == dc.asdict(rec["cfg"]), svc.config
    assert svc.stats.indexed == expect["nodes"]
    wait_drained(svc.corpus())
    t_idx = time.perf_counter() - t0
    assert list(svc.corpus()._ids) == rec["rows"], "row order after recovery"
    K.reset_launch_counts()
    answers = [svc.vector_candidates(q, k=VEC_K) for q in rec["queries"]]
    launches = K.launch_counts()["streaming_topk_bf16"]
    svc.shutdown()
    same = sum(a == b for a, b in zip(answers, rec["answers"]))
    log(f"[phase14] 14a open_db from the close-time snapshot "
        f"({snap_bytes} bytes, log {log_bytes} bytes): {t_rec:.2f}s "
        f"({expect['nodes'] / t_rec:.1f} nodes/s); counts, "
        f"{len(expect['ids'])} contents and embeddings bit for bit (10.8's "
        f"{len(expect['learned'])} learned nodes among them), "
        f"{len(expect['inferred'])} inferred edges with their confidences, "
        f"{len(expect['deleted'])} deleted ids absent; db.search "
        f"indexed in {t_idx:.2f}s, row order equal; {same} of "
        f"{VEC_QUERIES} vector answers (k={VEC_K}) equal bit for bit to "
        f"phase 10's fresh service; streaming_topk_bf16 launches {launches}")
    assert same == VEC_QUERIES, "recovered answers differ"
    assert launches > 0, "the recovered corpus missed kernel #2"
    return db


def phase_replay() -> None:
    """14b: the replay child's results (it ran beside phases 6 to 14):
    the crash image's whole WAL replayed to phase 10's state, then
    compact, close and a reopen with the same counts."""
    expect, _ = expect_state()
    lines, _, seconds = collect_child("replay", 0)
    rep = json.loads(next(ln for ln in lines
                          if ln.startswith("REPLAYED"))[len("REPLAYED "):])
    again = json.loads(next(ln for ln in lines
                            if ln.startswith("REOPENED"))[len("REOPENED "):])
    log(f"[phase14] 14b WAL replay of the crash image ({rep['wal_bytes']} "
        f"bytes, {rep['records']} records, no snapshot) in a CPU child: "
        f"{rep['seconds']:.2f}s, {rep['records'] / rep['seconds']:.1f} "
        f"records/s (14a's snapshot path above); counts, contents, "
        f"embeddings bit for bit and deletions equal to phase 10's; "
        f"compact() {again['compact']:.2f}s (snapshot "
        f"{again['snapshot_bytes']} bytes), close() {again['close']:.2f}s, "
        f"reopen from the snapshot {again['reopen']:.2f}s, counts "
        f"{again['counts']}; the child's wall {seconds:.1f}s")
    assert rep["records"] > expect["nodes"]
    assert again["counts"] == [expect["nodes"], expect["edges"]]


def phase_crash() -> None:
    """14c: two children crashed by SIGKILL at a seeded point. The default
    chain (child 1): every write before its flush is present after the
    reopen, the later writes present are a prefix of their order, and the
    WAL is intact but for a torn tail, which the first append repairs. The
    synchronous chain with fsync and the native codec (child 2): every
    acknowledged write reads back."""
    from nornicdb_tpu_torch.storage import Node, open_storage

    expect, embs = expect_state()
    n = CRASH_DOCS
    with open(os.path.join(CHAIN_DIR, "crash_docs", "docs.json")) as f:
        edges = json.load(f)["edges"]

    # child 1: the default chain
    lines, (_, d1, kill1), t_child = collect_child("async", -9)
    flushed = [ln.split() for ln in lines if ln.startswith("FLUSHED")]
    acked = [int(ln.split()[1]) for ln in lines if ln.startswith("ACK")]
    assert flushed and flushed[0][1:] == [str(n), str(len(edges))], flushed
    assert acked == list(range(kill1)), ("acks", len(acked), kill1)
    assert "CUDA False" in lines
    t0 = time.perf_counter()
    st = open_storage(d1)
    t_open = time.perf_counter() - t0
    wal = st.base.wal
    torn = wal.stats.truncated_tail_records
    assert not wal.stats.degraded, wal.stats.corruption_info
    got = st.batch_get_nodes([f"c{i}" for i in range(n)])
    assert len(got) == n and st.edge_count() == len(edges)
    for i in range(0, n, 97):
        assert got[i].embedding.tobytes() == embs[i].tobytes()
        assert got[i].properties["content"] == expect["contents"][i]
    late = [j for j in range(CRASH_LATE) if st.batch_get_nodes([f"late{j}"])]
    assert late == list(range(len(late))), "later writes not a prefix"
    assert len(late) <= kill1
    st.create_node(Node(id="after-crash"))
    st.flush()
    n_rec, clean = wal.verify_integrity()
    log(f"[phase14] 14c child 1 (default chain): {n} documents and "
        f"{len(edges)} edges flushed, killed after {kill1} of {CRASH_LATE} "
        f"later writes were acknowledged; child done {t_child:.1f}s after its "
        f"start; reopened in "
        f"{t_open:.2f}s: all flushed writes present, {len(late)} later "
        f"writes present, a prefix of their order (acknowledged is not "
        f"durable before a flush); torn tail at the kill: {torn > 0}; "
        f"verify_integrity after the first append: {n_rec} records, clean "
        f"{clean}")
    assert clean, "WAL not intact after the repairing append"

    # child 2: synchronous appends, fsync, the native codec
    lines, (_, d2, kill2), t_child = collect_child("sync", -9)
    info = json.loads(next(ln for ln in lines
                           if ln.startswith("NATIVE"))[len("NATIVE "):])
    fs = json.loads(next(ln for ln in lines
                         if ln.startswith("FSYNC"))[len("FSYNC "):])
    acked = [int(ln.split()[1]) for ln in lines if ln.startswith("ACK")]
    assert info["enabled"], info
    assert os.path.dirname(info["library"]) == info["build_dir"], info
    assert os.path.basename(info["library"]).startswith("libwalcodec-")
    assert acked == list(range(kill2)), ("acks", len(acked), kill2)
    assert "CUDA False" in lines
    st = open_storage(d2, async_writes=False, wal_sync=True)
    got = st.batch_get_nodes([f"s{i}" for i in acked])
    assert [g.id for g in got] == [f"s{i}" for i in acked]
    for g, i in zip(got, acked):
        assert g.embedding.tobytes() == embs[i].tobytes()
    n_rec, clean = st.wal.verify_integrity()
    p50 = hist_quantile(fs["bounds"], fs["counts"], 0.5)
    log(f"[phase14] 14c child 2 (async_writes=False, wal_sync=True, native "
        f"codec {info['library']}, built in {info['build_seconds']}s): "
        f"killed after {kill2} acknowledged writes, all {len(got)} read "
        f"back; child done {t_child:.1f}s after its start; "
        f"nornicdb_wal_fsync_seconds in the "
        f"child: {fs['count']} fsyncs, p50 {p50 * 1e3:.3f}ms (bucket "
        f"interpolated), mean {fs['sum'] / max(fs['count'], 1) * 1e3:.3f}ms; "
        f"verify_integrity {n_rec} records, clean {clean}")
    assert clean and n_rec == kill2 and fs["count"] == kill2


def edge_scan(storage) -> tuple[list, np.ndarray, np.ndarray]:
    """``gds_procedures._edge_arrays``'s scan branch: sorted ids and the
    (src, dst) index arrays of every edge."""
    ids = sorted(n.id for n in storage.all_nodes())
    index = {id_: i for i, id_ in enumerate(ids)}
    src, dst = [], []
    for e in storage.all_edges():
        a, b = index.get(e.start_node), index.get(e.end_node)
        if a is not None and b is not None:
            src.append(a)
            dst.append(b)
    return ids, np.asarray(src, np.int32), np.asarray(dst, np.int32)


def same_edges(view, scan) -> bool:
    ids, src, dst = scan
    if list(view.ids) != ids or len(view.src) != len(src):
        return False
    a = np.lexsort((view.dst, view.src))
    b = np.lexsort((dst, src))
    return bool(np.array_equal(view.src[a], src[b])
                and np.array_equal(view.dst[a], dst[b]))


def pagerank_check(GA, view, tag: str) -> str:
    """PageRank on the card over a snapshot's arrays against the float64
    power iteration, under phase 12's bounds."""
    n = len(view.ids)
    t0 = time.perf_counter()
    ranks = GA.pagerank(view.src, view.dst, n)  # device=None: the card
    t_pr = time.perf_counter() - t0
    l1, top_rel = pagerank_error(ranks, pagerank_f64(view.src, view.dst, n))
    assert l1 <= PR_L1_TOL, (tag, "pagerank L1", l1)
    assert top_rel <= PR_TOP_REL_TOL, (tag, "pagerank top ranks", top_rel)
    return (f"pagerank {t_pr * 1e3:.2f}ms, L1 {l1:.4e}, top-{PR_TOP} "
            f"relative error {top_rel:.4e}")


def phase_adjacency(seed: int, storage) -> None:
    """14d: the adjacency snapshot over the recovered chain feeds the
    card: its edge arrays equal a scan's, PageRank and WCC on the card over
    them, mutations through the chain, build_graph's snapshot branch, BFS
    against graph_algos over build_csr."""
    import types

    from nornicdb_tpu_torch.linkpredict import build_graph as lp_graph
    from nornicdb_tpu_torch.ops import graph_algos as GA
    from nornicdb_tpu_torch.storage import Edge, Node, attach_snapshot
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    # one traced write, flush and snapshot build: phase 13 reads its spans
    with tracer.start_trace("phase14.chain") as root:
        storage.create_node(Node(id="traced", labels=["Doc"]))
        storage.flush()
        snap = attach_snapshot(storage)
        t0 = time.perf_counter()
        assert snap.ensure()
        t_build = time.perf_counter() - t0
    TRACED["phase14"] = root.trace_id
    t0 = time.perf_counter()
    view = snap.edge_arrays()
    t_view = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = edge_scan(storage)
    t_scan = time.perf_counter() - t0
    assert same_edges(view, scan), "edge_arrays differ from the scan"
    n, m = len(view.ids), len(view.src)
    pr = pagerank_check(GA, view, "14d")
    t0 = time.perf_counter()
    labels = GA.connected_components(view.src, view.dst, n)
    t_wcc = time.perf_counter() - t0
    want = scipy_wcc(view.src, view.dst, n)
    n_comp = len(np.unique(want))
    assert np.array_equal(labels, want), "WCC"
    log(f"[phase14] 14d snapshot build {t_build * 1e3:.1f}ms ({n} nodes, "
        f"{m} edges), edge_arrays {t_view * 1e3:.1f}ms against a scan of "
        f"all_edges() {t_scan * 1e3:.1f}ms, equal (sorted ids, the same "
        f"(src, dst) multiset); on the card: {pr}; WCC {t_wcc * 1e3:.2f}ms, "
        f"{n_comp} components equal to scipy's")

    rng = np.random.default_rng(seed + 16)
    gen = snap.generation()
    t0 = time.perf_counter()
    for k in range(ADJ_MUTATIONS):
        a, b = rng.integers(0, EMBED_TEXTS, 2)
        storage.create_edge(Edge(id=f"m{k}", start_node=f"t{a}",
                                 end_node=f"t{b}"))
    expect, _ = expect_state()
    # phase 10's e<k>, not 10.8's inferred edges
    victims = rng.choice(m - len(expect["inferred"]), ADJ_MUTATIONS,
                         replace=False)
    for k in victims.tolist():
        storage.delete_edge(f"e{k}")
    t_mut = time.perf_counter() - t0
    view2 = snap.edge_arrays()
    assert snap.generation() != gen and view2 is not view
    assert same_edges(view2, edge_scan(storage)), "after the mutations"
    assert len(view2.src) == m
    pr2 = pagerank_check(GA, view2, "14d mutated")

    stats0 = snap.stats_snapshot()
    t0 = time.perf_counter()
    g = lp_graph(storage)
    t_g = time.perf_counter() - t0
    assert g is snap.graph_view(), "build_graph missed the snapshot branch"
    t0 = time.perf_counter()
    g_scan = lp_graph(types.SimpleNamespace(all_nodes=storage.all_nodes,
                                            all_edges=storage.all_edges))
    t_gs = time.perf_counter() - t0
    assert (g.ids, g.index, g.neighbors) == (g_scan.ids, g_scan.index,
                                             g_scan.neighbors)
    assert snap.stats_snapshot()["builds"] == stats0["builds"] == 1
    indptr, indices = GA.build_csr(view2.src, view2.dst, n)
    starts = rng.choice(n, ADJ_STARTS, replace=False)
    t_bfs = 0.0
    for s in starts.tolist():
        t0 = time.perf_counter()
        dist = snap.bfs_distances(view2.ids[s], "both")
        t_bfs += time.perf_counter() - t0
        want = GA.bfs_distances_csr(indptr, indices, s, n)
        got = {snap.id_of(i): int(dist[i]) for i in np.nonzero(dist >= 0)[0]}
        assert got == {view2.ids[i]: int(want[i])
                       for i in np.nonzero(want >= 0)[0]}, ("bfs", s)
    log(f"[phase14] 14d {ADJ_MUTATIONS} edges created and {ADJ_MUTATIONS} "
        f"deleted through the chain in {t_mut:.2f}s: generation moved, "
        f"edge_arrays equal a fresh scan, {pr2}; build_graph "
        f"{t_g * 1e3:.1f}ms from the snapshot (builds still 1) against "
        f"{t_gs * 1e3:.1f}ms by its scan branch, equal; BFS from "
        f"{ADJ_STARTS} starts {t_bfs / ADJ_STARTS * 1e3:.2f}ms each, equal "
        f"to bfs_distances_csr; snapshot "
        f"{json.dumps(snap.stats_snapshot())}")


def phase_segment_and_databases(rec: dict) -> None:
    """14e: the native segment store (built from the port's copy) holds
    CRASH_DOCS documents across a reopen and serves SEG_QUERIES vector
    queries equal bit for bit to a MemoryEngine-backed service over the
    same documents in the same order; two databases with shared ids in a
    DatabaseManager over a durable chain keep their counts, their search
    answers and, after a reopen, their metadata apart."""
    import dataclasses as dc

    from nornicdb_tpu_torch.multidb import DatabaseManager
    from nornicdb_tpu_torch.search import SearchService
    from nornicdb_tpu_torch.storage import MemoryEngine, Node, native
    from nornicdb_tpu_torch.storage import open_storage

    expect, embs = expect_state()
    n = CRASH_DOCS
    d = os.path.join(CHAIN_DIR, "seg")
    t0 = time.perf_counter()
    seg = open_storage(d, engine="segment")
    t_open = time.perf_counter() - t0
    lib = native.library_path("segstore")
    assert os.path.dirname(lib) == str(native.BUILD_DIR)
    t0 = time.perf_counter()
    for i in range(n):
        seg.create_node(Node(id=f"g{i}", labels=["Doc"],
                             properties={"content": expect["contents"][i]},
                             embedding=embs[i]))
    seg.flush()
    t_write = time.perf_counter() - t0
    seg.close()
    t0 = time.perf_counter()
    seg = open_storage(d, engine="segment")
    t_reopen = time.perf_counter() - t0
    order = list(seg.all_nodes())
    got = {x.id: x for x in order}
    assert seg.node_count() == n == len(got)
    for i in range(n):
        x = got[f"g{i}"]
        assert x.properties["content"] == expect["contents"][i]
        assert x.embedding.tobytes() == embs[i].tobytes()
    mem = MemoryEngine()
    for node in order:
        mem.create_node(node)
    answers = []
    for eng in (seg, mem):
        svc = SearchService(eng, config=dc.replace(rec["cfg"]), device="cuda")
        assert svc.build_indexes() == n
        wait_drained(svc.corpus())
        answers.append((list(svc.corpus()._ids),
                        [svc.vector_candidates(q, k=VEC_K)
                         for q in embs[:SEG_QUERIES]]))
        svc.shutdown()
    seg_bytes = du_bytes(d)
    seg.close()
    assert answers[0][0] == [x.id for x in order]
    assert answers[0] == answers[1], "segment-backed answers differ"
    log(f"[phase14] 14e segment store: library {os.path.basename(lib)} "
        f"built in {native.build_seconds.get('segstore', 0.0):.2f}s (first "
        f"open {t_open:.2f}s); {n} documents written in {t_write:.2f}s "
        f"({n / t_write:.1f}/s), reopened in {t_reopen:.2f}s, contents and "
        f"embeddings equal ({seg_bytes} bytes on disk); {SEG_QUERIES} vector "
        f"queries on the card equal bit for bit to a MemoryEngine-backed "
        f"service over the same documents in the same order")

    d = os.path.join(CHAIN_DIR, "mdb")
    base = open_storage(d)
    mgr = DatabaseManager(base)
    mgr.create_database("a")
    mgr.create_database("b")
    mgr.create_alias("alpha", "a")
    half = MDB_DOCS // 2
    spans = {"a": range(0, MDB_DOCS), "b": range(half, half + MDB_DOCS)}
    for name, docs in (("a", range(MDB_DOCS)),
                       ("b", range(MDB_DOCS, 2 * MDB_DOCS))):
        st = mgr.get_storage(name)
        for i, j in zip(spans[name], docs):
            st.create_node(Node(id=f"d{i}", properties={
                "content": expect["contents"][j], "db": name},
                embedding=embs[j]))
    base.flush()
    shared = f"d{half}"
    assert (mgr.get_storage("a").get_node(shared).properties["db"],
            mgr.get_storage("b").get_node(shared).properties["db"]) == (
        "a", "b")
    only_here = 0  # answers naming an id the other database lacks
    for name, other in (("a", "b"), ("b", "a")):
        st = mgr.get_storage(name)
        assert st.node_count() == MDB_DOCS, (name, st.node_count())
        own = {f"d{i}" for i in spans[name]}
        theirs = {f"d{i}" for i in spans[other]}
        svc = SearchService(st, config=dc.replace(rec["cfg"]), device="cuda")
        assert svc.build_indexes() == MDB_DOCS
        wait_drained(svc.corpus())
        for q in embs[: 2 * MDB_DOCS: 2 * MDB_DOCS // 32]:
            res = svc.vector_candidates(q, k=VEC_K)
            assert res and {i for i, _ in res} <= own, name
            only_here += sum(i not in theirs for i, _ in res)
        svc.shutdown()
    assert only_here > 0
    stats = mgr.storage_stats()
    base.close()
    base = open_storage(d)
    mgr2 = DatabaseManager(base)
    back = (sorted(mgr2.list_databases()), mgr2.resolve("alpha"),
            mgr2.storage_stats())
    base.close()
    log(f"[phase14] 14e DatabaseManager over open_storage: databases a and "
        f"b with {MDB_DOCS} nodes each, {MDB_DOCS - half} ids shared holding "
        f"different documents; each database's SearchService answered 32 "
        f"queries from its own nodes only ({only_here} answers name an id "
        f"the other database lacks); after a reopen "
        f"{json.dumps(back)}")
    assert {"a", "b"} <= set(back[0]) and back[1] == "a"
    assert back[2] == stats and stats["a"]["nodes"] == MDB_DOCS


def phase_storage(K, seed: int, rec: dict) -> None:
    """Phase 14: the storage chain; see the module docstring. 14b's and
    14c's children were started at the end of phase 10 and are collected
    here (14b last: it is the longest)."""
    import shutil

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    recovered = phase_recover(K, rec)
    log(f"[phase14] 14a {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_crash()
    log(f"[phase14] 14c {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_adjacency(seed, recovered.storage)
    # flushed and left open: a close would write a 1.5 GB snapshot that
    # nothing reads
    recovered.flush()
    del recovered
    gc.collect()
    log(f"[phase14] 14d {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_segment_and_databases(rec)
    log(f"[phase14] 14e {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_replay()
    log(f"[phase14] 14b {time.perf_counter() - t0:.1f}s waiting for the "
        f"replay child")
    sizes = {name: du_bytes(os.path.join(CHAIN_DIR, name))
             for name in sorted(os.listdir(CHAIN_DIR))
             if os.path.isdir(os.path.join(CHAIN_DIR, name))}
    free = shutil.disk_usage(CHAIN_DIR).free
    shutil.rmtree(CHAIN_DIR)
    log(f"[phase14] data directories on disk before deletion "
        f"{json.dumps(sizes)} (free {free} bytes); {CHAIN_DIR} deleted; "
        f"phase 14 {time.perf_counter() - t_all:.1f}s")


def parse_exposition(text: str) -> dict:
    """A strict reader of Prometheus text exposition (the port carries no
    parser until its servers come): every sample belongs to a family
    declared once by ``# TYPE``, label pairs are well formed, values
    parse, and every histogram's buckets are cumulative with ``+Inf``
    equal to ``_count``. Returns family -> {kind, help, samples: [(name,
    labels, value)]}."""
    import re

    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    pair_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    fams: dict = {}
    helps: dict = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            helps[name] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            assert name not in fams, f"TYPE of {name} declared twice"
            assert kind in ("counter", "gauge", "histogram", "summary",
                            "untyped"), line
            fams[name] = {"kind": kind, "help": helps.get(name, ""),
                          "samples": []}
            continue
        assert not line.startswith("#"), line
        match = sample_re.match(line)
        assert match, f"malformed sample {line!r}"
        name, labelstr, value = match.groups()
        fam = name
        if fam not in fams:
            fam = next((name[:-len(x)] for x in ("_bucket", "_sum", "_count")
                        if name.endswith(x) and name[:-len(x)] in fams), None)
        assert fam is not None, f"sample before its TYPE: {line!r}"
        labels = {}
        if labelstr:
            pairs = pair_re.findall(labelstr)
            assert ",".join(f'{k}="{v}"' for k, v in pairs) == labelstr, line
            labels = dict(pairs)
        fams[fam]["samples"].append((name, labels, float(value)))
    for fam, block in fams.items():
        if block["kind"] != "histogram":
            continue
        series: dict = {}
        for name, labels, v in block["samples"]:
            key = tuple(sorted((k, x) for k, x in labels.items() if k != "le"))
            series.setdefault(key, {"buckets": [], "count": None})
            if name.endswith("_bucket"):
                series[key]["buckets"].append(v)
            elif name.endswith("_count"):
                series[key]["count"] = v
        for key, ser in series.items():
            b = ser["buckets"]
            assert b == sorted(b) and b and b[-1] == ser["count"], (fam, key)
    return fams


def sample_total(fams: dict, fam: str, suffix: str = "", **labels) -> float:
    """The sum of a family's samples named fam + suffix whose labels hold
    ``labels``."""
    block = fams.get(fam)
    if block is None:
        return 0.0
    return sum(v for name, lab, v in block["samples"]
               if name == fam + suffix
               and all(lab.get(k) == x for k, x in labels.items()))


def span_costs() -> tuple[float, float]:
    """The tracer's cost on this host, as TestOverheadMicrobench measures
    it: microseconds a ``tracer.span`` with no trace active, and a span
    recorded inside a trace (a root and four children a request), each
    beyond the same loop without spans; best of five."""
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    n, state = 50_000, {}

    def work(i: int) -> None:
        state["k"] = i

    def best(fn) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    def base():
        for i in range(n):
            work(i)

    def untraced():
        for i in range(n):
            with tracer.span("bench.op"):
                work(i)

    def traced():
        for i in range(0, n, 5):
            with tracer.start_trace("bench.request"):
                work(i)
                for j in range(1, 5):
                    with tracer.span("bench.op"):
                        work(i + j)

    t_base = best(base)
    cost = ((best(untraced) - t_base) / n * 1e6,
            (best(traced) - t_base) / n * 1e6)
    tracer.clear()
    return cost


def phase_registry() -> None:
    """Phase 13: the port's registry after the whole run, rendered and
    parsed strictly, with the families every slice reports held non-zero
    and the generated-token counter equal to the engines' own counts; the
    cost model's accuracy, the predicted-deadline sheds and the tracer's
    cost on this host."""
    from nornicdb_tpu_torch.telemetry import REGISTRY
    from nornicdb_tpu_torch.telemetry.costmodel import COST_MODEL

    t0 = time.perf_counter()
    text = REGISTRY.render_prometheus()
    t_render = time.perf_counter() - t0
    fams = parse_exposition(text)
    programs = {(sub, kind): sample_total(
        fams, "nornicdb_device_programs_total", subsystem=sub, kind=kind)
        for sub, kind in (("search", "dense"), ("search", "ivf"),
                          ("serving", "embed"), ("genserve", "ragged"))}
    seen = {
        "nornicdb_device_program_seconds": sample_total(
            fams, "nornicdb_device_program_seconds", "_count"),
        "nornicdb_serving_batches_total": sample_total(
            fams, "nornicdb_serving_batches_total"),
        "nornicdb_search_batch_size": sample_total(
            fams, "nornicdb_search_batch_size", "_count"),
        "nornicdb_device_sync_seconds": sample_total(
            fams, "nornicdb_device_sync_seconds", "_count"),
        "nornicdb_ivf_tunes_total": sample_total(
            fams, "nornicdb_ivf_tunes_total"),
        "nornicdb_cost_model_observations_total": sample_total(
            fams, "nornicdb_cost_model_observations_total"),
    }
    storage = {
        "nornicdb_wal_append_seconds": sample_total(
            fams, "nornicdb_wal_append_seconds", "_count"),
        "nornicdb_async_flush_seconds": sample_total(
            fams, "nornicdb_async_flush_seconds", "_count"),
        "nornicdb_async_flush_ops_total": sample_total(
            fams, "nornicdb_async_flush_ops_total"),
        "nornicdb_adjacency_maintenance_seconds": sample_total(
            fams, "nornicdb_adjacency_maintenance_seconds", "_count"),
    }
    from nornicdb_tpu_torch.telemetry.tracing import tracer

    entry = tracer.trace(TRACED["phase14"])
    span_names = sorted({s["name"] for s in entry["spans"]}) if entry else []
    tokens = sample_total(fams, "nornicdb_genserve_generated_tokens_total")
    counted = sum(GEN_COUNTED.values())
    rel = {f"{s}/{k}": COST_MODEL.median_rel_error(s, k)
           for s, k in (("serving", "embed"), ("genserve", "ragged"),
                        ("search", "dense"), ("search", "ivf"))}
    sheds = {
        "serving embed": sample_total(fams, "nornicdb_serving_sheds_total",
                                      path="embed",
                                      reason="predicted_deadline"),
        "serving search": sample_total(fams, "nornicdb_serving_sheds_total",
                                       path="search",
                                       reason="predicted_deadline"),
        "genserve": sample_total(fams, "nornicdb_genserve_sheds_total",
                                 reason="predicted_deadline"),
    }
    # the embed worker's, inference's and Heimdall's families (phase 9
    # registered Heimdall's named metrics as the JAX HTTP server does)
    learning = {
        "nornicdb_embed_retries_total": sample_total(
            fams, "nornicdb_embed_retries_total"),
        **{f"errors{{component={c!r}}}": sample_total(
            fams, "nornicdb_component_errors_total", component=c)
           for c in ("embed_queue", "inference.similarity",
                     "inference.create_edge", "heimdall.checkpoint_load")},
        **{n: sample_total(fams, n) for n in (
            "heimdall_chat_requests", "heimdall_prompt_tokens",
            "heimdall_completion_tokens")},
    }
    untraced_us, traced_us = span_costs()
    log(f"[phase13] registry: {len(text)} bytes, {len(fams)} families, "
        f"{sum(len(b['samples']) for b in fams.values())} samples, "
        f"rendered in {t_render * 1e3:.2f}ms and parsed strictly; device "
        f"programs {json.dumps({'/'.join(k): v for k, v in programs.items()})}"
        f"; {json.dumps(seen)}; generated tokens {tokens:.0f} against the "
        f"engines' {counted} ({json.dumps(GEN_COUNTED)}); storage "
        f"{json.dumps(storage)}; phase 14's traced write spans {span_names}; "
        f"the learning loop and Heimdall {json.dumps(learning)}")
    log(f"[phase13] cost model median relative error {json.dumps(rel)}; "
        f"predicted-deadline sheds in the registry {json.dumps(sheds)}, by "
        f"phase (engine sheds, client retries) {json.dumps(PREDICTED_SHEDS)}; "
        f"tracer cost on this host: {untraced_us:.4f}us a span with no "
        f"trace, {traced_us:.4f}us a span recorded in a trace")
    for key, v in programs.items():
        assert v > 0, ("nornicdb_device_programs_total", key)
    for fam, v in {**seen, **storage}.items():
        assert v > 0, fam
    for name in ("wal.append", "storage.flush", "adjacency.build"):
        assert name in span_names, ("span", name, span_names)
    assert tokens == counted > 0, ("generated tokens", tokens, counted)
    assert fams["nornicdb_embed_retries_total"]["kind"] == "counter"
    assert fams["heimdall_chat_requests"]["kind"] == "counter"
    for fam, v in learning.items():
        if fam.startswith("heimdall_"):
            assert v >= CHATS if fam == "heimdall_chat_requests" else v > 0
        else:
            assert v == 0, (fam, v)
    # the process-default device owner: READY for the whole run
    mgr = OWNER["manager"]
    st = mgr.stats()
    owner = {
        "state": {s: sample_total(fams, "nornicdb_backend_state", state=s)
                  for s in ("PROBING", "READY", "DEGRADED_CPU",
                            "RECOVERING")},
        **{f: sample_total(fams, f"nornicdb_backend_{f}") for f in (
            "degrades_total", "acquire_timeouts_total", "recoveries_total",
            "probe_failures_total", "lock_violations_total")},
        "fallbacks_total": {op: sample_total(
            fams, "nornicdb_backend_fallbacks_total", op=op)
            for op in ("search", "embed", "generate")},
        "probe_seconds_count": sample_total(
            fams, "nornicdb_backend_probe_seconds", "_count"),
    }
    cypher_fams = sorted(f for f in fams if f.startswith("nornicdb_cypher_"))
    backend_fams = sorted(f for f in fams
                          if f.startswith("nornicdb_backend_"))
    log(f"[phase13] device owner: {st['state']}, {st['probes_total']} "
        f"probes, probe latency p50 {st['probe_latency_p50_s'] * 1e3:.3f}ms "
        f"max {st['probe_latency_max_s'] * 1e3:.3f}ms, acquired in "
        f"{OWNER['acquire_s']:.2f}s, probe failures "
        f"{json.dumps(st['probe_failures'])}; registry {json.dumps(owner)}; "
        f"families {backend_fams + cypher_fams}")
    assert st["state"] == "READY", st
    assert owner["state"] == {"PROBING": 0.0, "READY": 1.0,
                              "DEGRADED_CPU": 0.0, "RECOVERING": 0.0}, owner
    for f in ("degrades_total", "acquire_timeouts_total"):
        assert owner[f] == 0 and st[f] == 0, (f, owner[f], st[f])
    assert set(owner["fallbacks_total"].values()) == {0.0}, owner
    assert owner["probe_seconds_count"] > 0, owner
    # the probe's device time stays far from the threshold that degrades
    assert st["probe_latency_max_s"] < 0.5 * mgr.probe_latency_threshold, st
    for fam in ("nornicdb_backend_state", "nornicdb_backend_probe_seconds",
                "nornicdb_backend_fallbacks_total",
                "nornicdb_cypher_offloads_total",
                "nornicdb_cypher_plan_cache_hits_total"):
        assert fam in fams, (fam, backend_fams + cypher_fams)


# ---------------------------------------------------------------- 10.9
def phase_cypher(K, db, served: dict, seed: int) -> None:
    """Phase 10.9: Cypher through ``db.cypher`` on the card over phase
    10's DB. (a) CYPHER_VEC_QUERIES ``CALL db.index.vector.queryNodes``
    calls from CYPHER_CLIENTS clients, each answer's ids equal to
    ``db.search.vector_candidates``; #2 launches, no IVF plan serves.
    (d) plan-cache hits on those calls; (e) Heimdall's ``query`` action.
    (b), (c) and the in-memory DB's plan cache run in a card child
    (``phase_cypher_offloads``)."""
    from nornicdb_tpu_torch.heimdall import Generator, HeimdallManager

    rng = np.random.default_rng(seed + 109)
    retry = _Backoff()

    def pcts(xs) -> str:
        ms = np.asarray(xs) * 1e3
        return f"p50 {np.median(ms):.2f}ms p99 {np.percentile(ms, 99):.2f}ms"

    # -- (a) queryNodes over phase 10's corpus
    t_a = time.perf_counter()
    embs = served["embs"]
    rows = rng.choice(len(embs), CYPHER_VEC_QUERIES, replace=False)
    vecs = (embs[rows] + 0.01 * rng.standard_normal(
        (CYPHER_VEC_QUERIES, embs.shape[1]))).astype(np.float32)
    q_a = ("CALL db.index.vector.queryNodes('default', 10, $v) "
           "YIELD node, score RETURN node.id, score")
    n_nodes = db.storage.node_count()
    ivf0 = ivf_dispatches()
    c0 = K.launch_counts()["streaming_topk_bf16"]
    answers: list = [None] * CYPHER_VEC_QUERIES
    lat_a: list = []
    errors: list = []

    def client(c: int) -> None:
        try:
            for i in range(c, CYPHER_VEC_QUERIES, CYPHER_CLIENTS):
                t = time.perf_counter()
                answers[i] = retry(db.cypher, q_a,
                                   {"v": vecs[i].tolist()}).rows
                lat_a.append(time.perf_counter() - t)
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CYPHER_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "cypher client hung"
    wall_a = time.perf_counter() - t_a
    launches_a = K.launch_counts()["streaming_topk_bf16"] - c0
    ivf_a = ivf_dispatches() - ivf0
    # ids equal; scores within one step of #2's packed decode: both
    # sides decode bins of the same corpus (tile_bits from its
    # capacity; a biased score in [2, 4) keeps 22 - tile_bits mantissa
    # bits), and a fused batch's product may land one bin away from a
    # lone query's
    from nornicdb_tpu_torch.ops.kernels import (
        pick_tile_n,
        streaming_geometry,
    )

    cap = db.search.corpus().capacity
    tile_bits = streaming_geometry(cap, pick_tile_n(cap), 1)[2]
    score_tol = 2.0 ** (tile_bits - 22)
    score_diff = 0.0
    for i in range(CYPHER_VEC_QUERIES):
        want = db.search.vector_candidates(vecs[i], k=10)
        got = answers[i]
        assert [r[0] for r in got] == [w[0] for w in want], (
            "queryNodes ids", i)
        score_diff = max(score_diff, float(np.max(np.abs(
            np.asarray([r[1] for r in got])
            - np.asarray([w[1] for w in want])))))
    assert score_diff <= score_tol, ("queryNodes scores", score_diff,
                                     score_tol)
    t_check = time.perf_counter() - t_a - wall_a
    log(f"[phase10.9] (a) {CYPHER_VEC_QUERIES} queryNodes calls from "
        f"{CYPHER_CLIENTS} clients over {n_nodes} nodes x "
        f"{embs.shape[1]} in {wall_a:.2f}s: {pcts(lat_a)}; each "
        f"answer's ids equal db.search.vector_candidates; #2 launched "
        f"{launches_a} times, IVF-pruned searches {ivf_a:.0f}, sheds "
        f"retried {retry.sheds}; max |score - vector_candidates'| "
        f"{score_diff:.6g} (bound: #2's decode step {score_tol:.6g} at "
        f"capacity {cap}, tile_bits {tile_bits}); the check "
        f"{t_check:.2f}s")
    assert launches_a > 0, "queryNodes missed #2"
    assert ivf_a == 0, ("an IVF plan served queryNodes", ivf_a)

    # -- (d) the plan cache on queryNodes (phase 10's DB; the
    # in-memory DB's repeats in cypher_offloads, in a card child)
    stats_db = db.cypher_stats()
    log(f"[phase10.9] (d) cypher_stats: phase 10's DB "
        f"{json.dumps(stats_db)}")
    assert stats_db["plan_cache"]["hits"] >= 0.9 * (
        CYPHER_VEC_QUERIES - 1), stats_db

    # -- (e) Heimdall's query action on phase 10's DB
    class Echo(Generator):
        def __init__(self, reply: str):
            self.reply = reply

        def generate(self, prompt, max_tokens=128):
            return self.reply

    count = HeimdallManager(Echo(
        '{"action": "query", "params": {"cypher": '
        '"MATCH (n) RETURN count(n)"}}'), db=db).chat(
        [{"role": "user", "content": "how many nodes?"}])
    refused = HeimdallManager(Echo(
        '{"action": "query", "params": {"cypher": '
        '"CREATE (n:Intruder) RETURN n"}}'), db=db).chat(
        [{"role": "user", "content": "add one"}])
    log(f"[phase10.9] (e) Heimdall's query action: count "
        f"{count['action_result']}, a CREATE "
        f"{refused['action_result']}")
    assert count["action_result"]["rows"] == [[
        db.storage.node_count()]], count
    assert "read-only" in refused["action_result"]["error"], refused
    assert not db.storage.get_nodes_by_label("Intruder")


def phase_cypher_offloads(K, embs: np.ndarray, seed: int) -> None:
    """10.9 (b), (c) and the in-memory half of (d), in a card child (they
    read nothing of phase 10's DB): an in-memory ``open_db("")`` on the
    card (synchronous storage, no result cache) holding CYPHER_ITEMS
    :Item nodes with scores tied in runs, and ORDER BY ... LIMIT 100 over
    >= 100,000 rows a query (the top-k offload, ``torch.topk`` on the
    card); then CYPHER_DOCS :Doc nodes with phase 8's embeddings
    (``embs``), and ORDER BY ``vector.similarity.cosine`` LIMIT 10 over
    >= 8,192 rows (VectorTopK, ``graph_masked_scores`` on the card). Each
    offload is used once a query at the default thresholds, never
    ``unavailable``, and CYPHER_CHECKED answers equal the generic
    engine's; the repeated shapes hit the plan cache. Logged: each
    shape's p50 / p99 and the offloads' device time from ``deviceprof``.
    The items use ``sku``, not ``id``: the columnar engine (the JAX
    package's too) sends ``n.id`` to its generic tail, which would take
    the query off the offload."""
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.cypher import CypherExecutor
    from nornicdb_tpu_torch.cypher.plan import OFFLOAD_CELLS
    from nornicdb_tpu_torch.db import Config
    from nornicdb_tpu_torch.telemetry import deviceprof

    for var in ("NORNICDB_CYPHER_OFFLOAD_MIN_ROWS",
                "NORNICDB_VECTOR_TOPK_MIN_ROWS",
                "NORNICDB_VECTOR_TOPK_CUTOVER"):
        assert var not in os.environ, ("10.9 runs at the defaults", var)
    rng = np.random.default_rng(seed + 110)
    device_s: dict = {"topk_offload": [], "vector_topk": []}

    def observe(sub, kind, shape, seconds):
        if sub == "cypher" and kind in device_s:
            device_s[kind].append(seconds)

    def pcts(xs) -> str:
        ms = np.asarray(xs) * 1e3
        return f"p50 {np.median(ms):.2f}ms p99 {np.percentile(ms, 99):.2f}ms"

    deviceprof.PROFILER.add_time_observer(observe)
    try:
        # -- (b) ORDER BY ... LIMIT over the top-k offload
        # synchronous storage (the async chain's label scans copy every
        # node a query) and no result cache (a repeated query would be
        # answered from it, never reaching the offload)
        mem = nornicdb_tpu_torch.open_db(
            "", Config(async_writes=False, embed_enabled=False,
                       query_cache_enabled=False))
        try:
            assert mem.device.type == "cuda"
            t0 = time.perf_counter()
            for s0 in range(0, CYPHER_ITEMS, CYPHER_BATCH):
                batch = [{"sku": i, "score": float((i // 16) % 4096) / 8,
                          "bucket": i % 128}
                         for i in range(s0, min(s0 + CYPHER_BATCH,
                                                CYPHER_ITEMS))]
                mem.cypher("UNWIND $rows AS r CREATE (:Item {sku: r.sku, "
                           "score: r.score, bucket: r.bucket})",
                           {"rows": batch})
            t_items = time.perf_counter() - t0
            gen = CypherExecutor(mem.storage, schema=mem.schema, db=mem,
                                 device="cuda")
            gen.columnar.enabled = False
            q_b = ("MATCH (i:Item) WHERE i.bucket < $b RETURN i.sku, "
                   "i.score ORDER BY i.score DESC LIMIT 100")
            used0 = OFFLOAD_CELLS["used"].value
            un0 = OFFLOAD_CELLS["unavailable"].value
            lat_b: list = []
            checked_b, t_gen_b = 0, 0.0
            for j in range(CYPHER_SHAPE_QUERIES):
                b = 98 + j % 30  # >= 98 of 128 buckets: >= 100,352 rows
                t = time.perf_counter()
                got = mem.cypher(q_b, {"b": b}).rows
                lat_b.append(time.perf_counter() - t)
                assert len(got) == 100
                if j % (CYPHER_SHAPE_QUERIES // CYPHER_CHECKED) == 0:
                    t = time.perf_counter()
                    assert got == gen.execute(q_b, {"b": b}).rows, (
                        "top-k offload vs generic", b)
                    t_gen_b += time.perf_counter() - t
                    checked_b += 1
            used_b = OFFLOAD_CELLS["used"].value - used0
            un_b = OFFLOAD_CELLS["unavailable"].value - un0
            log(f"[phase10.9] (b) {CYPHER_ITEMS} :Item nodes through "
                f"UNWIND ... CREATE in {t_items:.2f}s; "
                f"{CYPHER_SHAPE_QUERIES} ORDER BY i.score DESC LIMIT 100 "
                f"over >= 100,352 rows: {pcts(lat_b)}; offloads used "
                f"{used_b:.0f}, unavailable {un_b:.0f}; {checked_b} equal to "
                f"the generic engine ({t_gen_b:.2f}s); the offload's device "
                f"time "
                f"{pcts(device_s['topk_offload'])} "
                f"({len(device_s['topk_offload'])} calls)")
            assert used_b == CYPHER_SHAPE_QUERIES, ("offloads used", used_b)
            assert un_b == 0, ("offloads unavailable", un_b)

            # -- (c) VectorTopK over phase 8's embeddings
            t0 = time.perf_counter()
            for s0 in range(0, CYPHER_DOCS, 1024):
                batch = [{"doc": i, "topic": i % 16,
                          "emb": embs[i].tolist()}
                         for i in range(s0, min(s0 + 1024, CYPHER_DOCS))]
                mem.cypher("UNWIND $rows AS r CREATE (:Doc {doc: r.doc, "
                           "topic: r.topic, emb: r.emb})", {"rows": batch})
            t_docs = time.perf_counter() - t0
            q_c = ("MATCH (d:Doc) WHERE d.topic IN $t RETURN d.doc ORDER BY "
                   "vector.similarity.cosine(d.emb, $q) DESC LIMIT 10")
            used0 = OFFLOAD_CELLS["used"].value
            un0 = OFFLOAD_CELLS["unavailable"].value
            lat_c: list = []
            checked_c, t_gen_c = 0, 0.0
            for j in range(CYPHER_SHAPE_QUERIES):
                topics = sorted(rng.choice(16, 8 + j % 8,
                                           replace=False).tolist())
                qv = embs[rng.integers(len(embs))].tolist()
                p = {"t": topics, "q": qv}
                t = time.perf_counter()
                got = mem.cypher(q_c, p).rows
                lat_c.append(time.perf_counter() - t)
                assert len(got) == 10
                if j % (CYPHER_SHAPE_QUERIES // CYPHER_CHECKED) == 0:
                    t = time.perf_counter()
                    assert got == gen.execute(q_c, p).rows, (
                        "VectorTopK vs generic", j)
                    t_gen_c += time.perf_counter() - t
                    checked_c += 1
            used_c = OFFLOAD_CELLS["used"].value - used0
            un_c = OFFLOAD_CELLS["unavailable"].value - un0
            log(f"[phase10.9] (c) {CYPHER_DOCS} :Doc nodes x "
                f"{embs.shape[1]} in {t_docs:.2f}s; {CYPHER_SHAPE_QUERIES} "
                f"ORDER BY vector.similarity.cosine LIMIT 10 over >= 8,192 "
                f"rows: {pcts(lat_c)}; offloads used {used_c:.0f}, "
                f"unavailable {un_c:.0f}; {checked_c} equal to the generic "
                f"engine ({t_gen_c:.2f}s); graph_masked_scores' device time "
                f"{pcts(device_s['vector_topk'])} "
                f"({len(device_s['vector_topk'])} calls)")
            assert used_c == CYPHER_SHAPE_QUERIES, ("vector used", used_c)
            assert un_c == 0, ("vector unavailable", un_c)

            # -- (d) the plan cache on the repeated shapes
            stats_mem = mem.cypher_stats()
            log(f"[phase10.9] (d) cypher_stats: in-memory DB "
                f"{json.dumps(stats_mem)}")
            # most repeats hit (a few concurrent first calls may each
            # miss before one plan lands)
            assert stats_mem["plan_cache"]["hits"] >= 0.9 * (
                2 * CYPHER_SHAPE_QUERIES - 2), stats_mem
        finally:
            mem.close()

    finally:
        deviceprof.PROFILER.remove_time_observer(observe)


# ---------------------------------------------------------------- phase 16
class GraphDeviceTimes:
    """CUDA events around the device work of the graph procedures:
    ``graph_algos.pagerank_device`` and ``wcc_device`` and the link
    prediction product (``topology._full_precision_matmul``'s upload,
    ``torch.matmul`` and download), patched in for the ``with`` block.
    The ``deviceprof`` ledger records no graph program in either package,
    so this script times them itself. A no-op on a CPU device."""

    def __init__(self, device) -> None:
        self.on = getattr(device, "type", device) == "cuda"
        self.ms: dict = {"pagerank": [], "wcc": [], "gemm": []}

    def _timed(self, kind: str, fn):
        import torch

        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            end.synchronize()
            self.ms[kind].append(start.elapsed_time(end))
            return out

        return call

    def __enter__(self):
        from nornicdb_tpu_torch.linkpredict import topology
        from nornicdb_tpu_torch.ops import graph_algos as GA

        self._saved = [(GA, "pagerank_device", GA.pagerank_device),
                       (GA, "wcc_device", GA.wcc_device),
                       (topology, "_full_precision_matmul",
                        topology._full_precision_matmul)]
        if self.on:
            GA.pagerank_device = self._timed("pagerank", GA.pagerank_device)
            GA.wcc_device = self._timed("wcc", GA.wcc_device)
            mm = self._saved[2][2]
            topology._full_precision_matmul = (
                lambda dev: self._timed("gemm", mm(dev)))
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def take(self, kind: str) -> str:
        ms, self.ms[kind] = self.ms[kind], []
        return ("device " + " + ".join(f"{t:.3f}" for t in ms) + " ms"
                if ms else "device not measured (CPU)")


def numpy_top(g, method: str, limit: int) -> list:
    """``top_candidates`` ranked over ``batch_scores(use_device=False)``,
    the port's numpy branch (the JAX package's own rule below 64 nodes)."""
    from nornicdb_tpu_torch.linkpredict import batch_scores

    s = batch_scores(g, method, use_device=False)
    for i, nbrs in enumerate(g.neighbors):
        for j in nbrs:
            s[i, j] = 0.0
    iu = np.triu_indices(g.n, k=1)
    vals = s[iu]
    out = []
    for k in np.argsort(-vals)[:limit]:
        if float(vals[k]) <= 0:
            break
        out.append((g.ids[int(iu[0][k])], g.ids[int(iu[1][k])],
                    float(vals[k])))
    return out


def aa_ranking(g, source: str, top_k: int) -> list:
    """``gds.linkPrediction.adamicAdar.stream``'s ranking of ``source``,
    computed from ``score_pair`` over the candidates that share a
    neighbour with it (no other pair scores above 0), in index order then
    by score."""
    from nornicdb_tpu_torch.linkpredict import score_pair

    si = g.index[source]
    near = g.neighbors[si]
    cands = sorted({j for z in near for j in g.neighbors[z]} - near - {si})
    scored = [(g.ids[j], score_pair(g, source, g.ids[j], "adamicAdar"))
              for j in cands]
    scored = [t for t in scored if t[1] > 0]
    scored.sort(key=lambda t: -t[1])
    return scored[:top_k]


def gds_read(db, rng, times: GraphDeviceTimes) -> None:
    """16a: GDS and APOC over phase 10's DB, which it leaves as it was."""
    from nornicdb_tpu_torch.filter import Kalman, KalmanConfig
    from nornicdb_tpu_torch.ops.graph_algos import (
        bfs_distances_csr,
        build_csr,
    )
    from nornicdb_tpu_torch.storage import attach_snapshot

    n0, m0 = db.storage.node_count(), db.storage.edge_count()
    snap = attach_snapshot(db.executor.storage)
    assert snap.ensure(), "phase 10's adjacency snapshot"
    view = snap.edge_arrays()
    ids, src, dst = list(view.ids), view.src, view.dst
    n = len(ids)
    assert (n, len(src)) == (n0, m0), ((n, len(src)), (n0, m0))

    def call(q: str, params=None) -> tuple:
        t0 = time.perf_counter()
        rows = db.cypher(q, params or {}).rows
        return rows, time.perf_counter() - t0

    # PageRank over every node
    rows, t = call("CALL gds.pageRank.stream({maxIterations: 20, "
                   "dampingFactor: 0.85}) YIELD node, score "
                   "RETURN id(node), score")
    assert [r[0] for r in rows] == ids, "pagerank rows vs the live ids"
    ranks = np.asarray([r[1] for r in rows], np.float32)
    t0 = time.perf_counter()
    ref = pagerank_f64(src, dst, n)
    t_ref = time.perf_counter() - t0
    l1, top_rel = pagerank_error(ranks, ref)
    log(f"[phase16] (a) gds.pageRank.stream over {n} nodes and {len(src)} "
        f"edges of phase 10's DB: {t:.2f}s, {times.take('pagerank')}; L1 "
        f"{l1:.4e} (at most {PR_L1_TOL:g}), top-{PR_TOP} relative error "
        f"{top_rel:.4e} (at most {PR_TOP_REL_TOL:g}) against the float64 "
        f"reference ({t_ref:.2f}s)")
    assert np.isfinite(ranks).all()
    assert l1 <= PR_L1_TOL, ("gds pagerank L1", l1)
    assert top_rel <= PR_TOP_REL_TOL, ("gds pagerank top ranks", top_rel)

    # components and degrees
    rows, t = call("CALL gds.wcc.stream() YIELD node, componentId "
                   "RETURN id(node), componentId")
    labels = np.asarray([r[1] for r in rows], np.int32)
    want = scipy_wcc(src, dst, n)
    log(f"[phase16] (a) gds.wcc.stream: {t:.2f}s, {times.take('wcc')}; "
        f"{len(np.unique(want))} components, equal to scipy's: "
        f"{bool(np.array_equal(labels, want))}")
    assert [r[0] for r in rows] == ids
    assert np.array_equal(labels, want), "gds.wcc vs scipy"
    rows, t = call("CALL gds.degree.stream() YIELD node, score "
                   "RETURN id(node), score")
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    got = np.asarray([r[1] for r in rows])
    log(f"[phase16] (a) gds.degree.stream: {t:.2f}s, equal to np.bincount: "
        f"{bool(np.array_equal(got, deg))}")
    assert [r[0] for r in rows] == ids and np.array_equal(got, deg)

    # link prediction and paths from seeded sources
    sources = [ids[i] for i in rng.choice(n, GDS_SOURCES, replace=False)]
    g = snap.graph_view()
    t_lp = 0.0
    for s in sources:
        rows, t = call("CALL gds.linkPrediction.adamicAdar.stream("
                       "{sourceNode: $s, topK: 10}) YIELD node2, score "
                       "RETURN id(node2), score", {"s": s})
        t_lp += t
        assert [tuple(r) for r in rows] == aa_ranking(g, s, 10), (
            "adamicAdar.stream", s)
    offsets, nbrs = build_csr(src, dst, n)
    index = {nid: i for i, nid in enumerate(ids)}
    t_path = t_hop = 0.0
    n_paths = 0
    for j, s in enumerate(sources):
        dist = bfs_distances_csr(offsets, nbrs, index[s], n)
        rows, t = call("CALL apoc.path.expand($s, null, null, 0, 2) "
                       "YIELD path RETURN [x IN nodes(path) | id(x)]",
                       {"s": s})
        t_path += t
        n_paths += len(rows)
        reached: dict = {}
        for (walk,) in rows:
            assert walk[0] == s and len(walk) <= 3, walk
            end = index[walk[-1]]
            reached[end] = min(reached.get(end, 9), len(walk) - 1)
        want = {int(i): int(dist[i])
                for i in np.nonzero((dist >= 0) & (dist <= 2))[0]}
        assert reached == want, ("apoc.path.expand vs BFS", s)
        if j >= GDS_HOP_SOURCES:
            continue
        rows, t = call("CALL apoc.neighbors.byhop($s, null, 2) "
                       "YIELD nodes, depth RETURN [x IN nodes | id(x)], depth",
                       {"s": s})
        t_hop += t
        levels = {d: sorted(index[x] for x in xs) for xs, d in rows}
        want = {d: np.nonzero(dist == d)[0].tolist() for d in (1, 2)}
        assert levels == {d: v for d, v in want.items() if v}, (
            "apoc.neighbors.byhop vs BFS", s)
    log(f"[phase16] (a) {GDS_SOURCES} sources: adamicAdar.stream top 10 "
        f"equal to score_pair's ranking over graph_view() ({t_lp:.2f}s); "
        f"apoc.path.expand to depth 2 ({n_paths} paths, {t_path:.2f}s) and, "
        f"from {GDS_HOP_SOURCES} of them, apoc.neighbors.byhop's levels "
        f"({t_hop:.2f}s) equal to a BFS over the edge arrays")

    # apoc.algo.pageRank over a subset, as an aggregate's argument
    pick = np.sort(rng.choice(n, GDS_SUBSET, replace=False))
    # the ids themselves (the function takes nodes or ids): a MATCH on
    # id(x) IN $ids would test every node against the list
    rows, t = call("UNWIND $ids AS i RETURN apoc.algo.pageRank(collect(i))",
                   {"ids": [ids[i] for i in pick]})
    got = rows[0][0]
    remap = np.full(n, -1, np.int64)
    remap[pick] = np.arange(len(pick))
    keep = (remap[src] >= 0) & (remap[dst] >= 0)
    ref = pagerank_f64(remap[src[keep]], remap[dst[keep]], len(pick))
    sub = np.asarray([got[ids[i]] for i in pick], np.float32)
    l1, top_rel = pagerank_error(sub, ref)
    log(f"[phase16] (a) apoc.algo.pageRank(collect(i)) over {len(pick)} "
        f"nodes ({int(keep.sum())} edges among them): {t:.2f}s, "
        f"{times.take('pagerank')}; L1 {l1:.4e} against the float64 "
        f"reference on the subgraph")
    assert len(got) == len(pick) and l1 <= PR_L1_TOL, ("apoc pagerank", l1)

    # pure APOC functions, then the Kalman functions
    rows, t = call("UNWIND range(0, $n - 1) AS i RETURN i, "
                   "apoc.text.join(['n', toString(i)], '-'), "
                   "apoc.text.lpad(toString(i), 6, '0'), "
                   "apoc.coll.sum([i, 2 * i, 3]), "
                   "apoc.coll.sort([i % 7, i % 3, i % 5]), "
                   "apoc.map.merge({a: i}, {b: i % 10})", {"n": GDS_ROWS})
    want = [[i, f"n-{i}", str(i).rjust(6, "0"), 3 * i + 3,
             sorted([i % 7, i % 3, i % 5]), {"a": i, "b": i % 10}]
            for i in range(GDS_ROWS)]
    log(f"[phase16] (a) apoc.text / apoc.coll / apoc.map over {GDS_ROWS} "
        f"rows: {t:.2f}s, equal to Python's: {rows == want}")
    assert rows == want, "pure APOC functions"
    series = np.cumsum(rng.normal(0.0, 1.0, GDS_SERIES)).tolist()
    k = Kalman(KalmanConfig(1e-3, 1e-1))
    want = [k.process(x) for x in series]
    smooth, t_s = call("RETURN kalman.smooth($xs)", {"xs": series})
    filt, t_f = call("UNWIND $xs AS m RETURN kalman.filter('phase16', m)",
                     {"xs": series})
    pred, _ = call("RETURN kalman.predict('phase16')")
    call("RETURN kalman.reset('phase16')")
    log(f"[phase16] (a) kalman.smooth and kalman.filter over a seeded "
        f"series of {GDS_SERIES}: {t_s * 1e3:.1f} / {t_f * 1e3:.1f}ms, equal "
        f"to the filter module's Kalman: {smooth[0][0] == want} / "
        f"{[r[0] for r in filt] == want}; predict {pred[0][0]:.4f}")
    assert smooth[0][0] == want and [r[0] for r in filt] == want
    assert pred[0][0] == k.predict()
    assert (db.storage.node_count(), db.storage.edge_count()) == (n0, m0), (
        "16a wrote to phase 10's DB")


def gds_write(device, seed: int, times: GraphDeviceTimes) -> None:
    """16b: the Graph500 graph in an in-memory DB on ``device``: the link
    prediction GEMMs, FastRP, the host algorithms and the graph catalog;
    then, in a second DB holding the subgraph of its GDS_CENTRAL
    highest-degree vertices, the centralities, the writing procedures, a
    trigger, and the export and import round trip into a third."""
    import shutil

    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.cypher import CypherExecutor
    from nornicdb_tpu_torch.db import Config
    from nornicdb_tpu_torch.ops import graph_algos as GA
    from nornicdb_tpu_torch.storage import Edge, Node, attach_snapshot

    cfg = Config(async_writes=False, embed_enabled=False,
                 query_cache_enabled=False)
    n = 1 << GDS_SCALE
    ks, kd = kronecker_edges(GDS_SCALE, GRAPH_EDGEFACTOR, seed + 16)
    ks, kd = ks.numpy(), kd.numpy()

    def load(db, keep_nodes, s, d, tag: str) -> None:
        for i in keep_nodes:
            db.storage.create_node(Node(id=f"{tag}{i}", labels=["V"]))
        for e, (a, b) in enumerate(zip(s.tolist(), d.tolist())):
            db.storage.create_edge(Edge(
                id=f"{tag}e{e}", start_node=f"{tag}{a}",
                end_node=f"{tag}{b}", type="LINKS"))

    def call(db, q: str, params=None) -> tuple:
        t0 = time.perf_counter()
        rows = db.cypher(q, params or {}).rows
        return rows, time.perf_counter() - t0

    mem = nornicdb_tpu_torch.open_db("", cfg, device=device)
    other = nornicdb_tpu_torch.open_db("", cfg, device=device)
    sub = nornicdb_tpu_torch.open_db("", cfg, device=device)
    try:
        assert mem.executor.device == mem.device
        t0 = time.perf_counter()
        load(mem, range(n), ks, kd, "g")
        t_load = time.perf_counter() - t0
        snap = attach_snapshot(mem.executor.storage)
        assert snap.ensure()
        view = snap.edge_arrays()
        src, dst, ids = view.src, view.dst, list(view.ids)
        g = snap.graph_view()
        log(f"[phase16] (b) Graph500 SCALE {GDS_SCALE} (edgefactor "
            f"{GRAPH_EDGEFACTOR}): {n} nodes and {len(ks)} edges through "
            f"the storage API of an in-memory DB on {mem.device} in "
            f"{t_load:.2f}s")

        # suggest: the adjacency GEMMs on the card
        for method in ("commonNeighbors", "adamicAdar"):
            rows, t = call(mem, "CALL gds.linkPrediction.suggest($m, $k) "
                           "YIELD node1, node2, score "
                           "RETURN id(node1), id(node2), score",
                           {"m": method, "k": LINK_LIMIT})
            t0 = time.perf_counter()
            want = numpy_top(g, method, LINK_LIMIT)
            t_np = time.perf_counter() - t0
            got = [tuple(r) for r in rows]
            cut = want[-1][2] * (1 + LINK_TOL) + LINK_TOL
            log(f"[phase16] (b) gds.linkPrediction.suggest({method}, "
                f"{LINK_LIMIT}): {t:.2f}s, {times.take('gemm')}; the numpy "
                f"branch {t_np:.2f}s; top {got[:2]}")
            assert len(got) == len(want) == LINK_LIMIT
            if method == "commonNeighbors":
                assert got == want, ("suggest commonNeighbors", got, want)
            else:
                assert ({r[:2] for r in got if r[2] > cut}
                        == {r[:2] for r in want if r[2] > cut}), (got, want)
                for a, b in zip(got, want):
                    assert abs(a[2] - b[2]) <= LINK_TOL * abs(b[2]), (a, b)

        # FastRP: host numpy in both packages, so bit-equal on the CPU
        q = (f"CALL gds.fastRP.stream({{embeddingDimension: {GDS_DIM}, "
             "randomSeed: 42}) YIELD nodeId, embedding "
             "RETURN nodeId, embedding")
        rows, t = call(mem, q)
        emb = np.asarray([r[1] for r in rows])
        norms = np.linalg.norm(emb, axis=1)
        linked = np.asarray([len(x) > 0 for x in g.neighbors])
        same = CypherExecutor(mem.storage, schema=mem.schema,
                              device="cpu").execute(q).rows == rows
        log(f"[phase16] (b) gds.fastRP.stream({GDS_DIM}): {t:.2f}s, "
            f"{emb.shape}, norms of the {int(linked.sum())} linked nodes in "
            f"[{norms[linked].min():.6f}, {norms[linked].max():.6f}], "
            f"{int((~linked).sum())} unlinked ones zero, equal to a CPU "
            f"executor's: {same}")
        assert emb.shape == (n, GDS_DIM) and [r[0] for r in rows] == ids
        assert np.allclose(norms[linked], 1.0, atol=1e-5)
        assert not norms[~linked].any() and same

        # the host algorithms, each against the same function
        for q, fn, col in (
                ("gds.louvain.stream", GA.louvain, "communityId"),
                ("gds.scc.stream", GA.strongly_connected_components,
                 "componentId"),
                ("gds.kcore.stream", GA.k_core, "coreValue"),
                ("gds.triangleCount.stream", GA.triangle_counts,
                 "triangleCount")):
            rows, t = call(mem, f"CALL {q}() YIELD node, {col} "
                           f"RETURN id(node), {col}")
            want = fn(src, dst, n)
            log(f"[phase16] (b) {q}: {t:.2f}s, equal to graph_algos over "
                f"the snapshot's arrays: "
                f"{[r[1] for r in rows] == [int(v) for v in want]}")
            assert [r[0] for r in rows] == ids
            assert [r[1] for r in rows] == [int(v) for v in want], q
        steps = [("CALL gds.graph.project('g', 'V', 'LINKS')",
                  [["g", n, len(ks)]]),
                 ("CALL gds.graph.list()", [["g", n, len(ks)]]),
                 ("CALL gds.graph.drop('g')", [["g"]]),
                 ("CALL gds.graph.exists('g')", [["g", False]])]
        for q, want in steps:
            assert call(mem, q)[0] == want, q
        log("[phase16] (b) gds.graph.project / list / drop / exists: counts "
            f"{n} nodes, {len(ks)} relationships")

        # betweenness and closeness (host Brandes, O(n m)) on a subgraph
        deg = np.bincount(ks, minlength=n) + np.bincount(kd, minlength=n)
        top = np.sort(np.argsort(-deg, kind="stable")[:GDS_CENTRAL])
        inside = np.zeros(n, bool)
        inside[top] = True
        keep = inside[ks] & inside[kd]
        load(sub, top.tolist(), ks[keep], kd[keep], "c")
        csnap = attach_snapshot(sub.executor.storage)
        assert csnap.ensure()
        cview = csnap.edge_arrays()
        for q, fn in (("gds.betweenness.stream", GA.betweenness_centrality),
                      ("gds.closeness.stream", GA.closeness_centrality)):
            rows, t = call(sub, f"CALL {q}() YIELD node, score "
                           "RETURN id(node), score")
            want = [float(v) for v in fn(cview.src, cview.dst,
                                         len(cview.ids))]
            log(f"[phase16] (b) {q} over the {GDS_CENTRAL} highest-degree "
                f"vertices ({int(keep.sum())} edges): {t:.2f}s, equal to "
                f"graph_algos: {[r[1] for r in rows] == want}")
            assert [r[0] for r in rows] == list(cview.ids)
            assert [r[1] for r in rows] == want, q

        # writing procedures, each with its counts, then the trigger and
        # the export, in the smaller DB (its 56,583 edges import in a third
        # of the big one's time)
        n_nodes, n_edges = sub.storage.node_count(), sub.storage.edge_count()
        rows, _ = call(sub, "CALL apoc.create.nodes(['W'], $ps) YIELD node "
                       "RETURN id(node)",
                       {"ps": [{"k": i} for i in range(100)]})
        made = [r[0] for r in rows]
        rows, _ = call(sub, "CALL apoc.create.node(['W', 'Hub'], {k: -1}) "
                       "YIELD node RETURN id(node)")
        hub = rows[0][0]
        rows, _ = call(sub, "MATCH (h:Hub), (w:W) WHERE w.k >= 0 "
                       "CALL apoc.create.relationship(h, 'OWNS', {w: w.k}, w) "
                       "YIELD rel RETURN count(rel)")
        assert rows == [[100]], rows
        merged = []
        for k in (7, 7, 500, 500):  # k 7 exists; 500 is made once
            rows, _ = call(sub, "CALL apoc.merge.node(['W'], {k: $k}, "
                           "{fresh: true}) YIELD node RETURN id(node)",
                           {"k": k})
            merged.append(rows[0][0])
        assert merged[0] == merged[1] in made and merged[2] == merged[3]
        assert merged[2] not in made
        rows, _ = call(sub, "MATCH (h:Hub), (w:W {k: 3}) CALL "
                       "apoc.merge.relationship(h, 'OWNS', {w: 3}, {}, w) "
                       "YIELD rel RETURN count(rel)")
        assert rows == [[1]]
        rows, _ = call(sub, "CALL apoc.refactor.rename.label('W', 'Owned') "
                       "YIELD total RETURN total")
        assert rows == [[102]], rows  # 100 + the hub + {k: 500}
        rows, _ = call(sub, "CALL apoc.refactor.rename.type('OWNS', 'HOLDS') "
                       "YIELD total RETURN total")
        assert rows == [[100]], rows
        rows, _ = call(sub, "MATCH (:Hub)-[r:HOLDS]->(w {k: 0}) "
                       "CALL apoc.refactor.invert(r) YIELD output "
                       "RETURN type(output)")
        assert rows == [["HOLDS"]]
        rows, _ = call(sub, "CALL apoc.periodic.iterate("
                       "'MATCH (o:Owned) RETURN o', 'SET o.seen = true', "
                       "{batchSize: 25}) YIELD batches, total, failedBatches "
                       "RETURN batches, total, failedBatches")
        assert rows == [[5, 102, 0]], rows
        seen, _ = call(sub, "MATCH (o:Owned) WHERE o.seen RETURN count(o)")
        assert seen == [[102]], seen
        assert (sub.storage.node_count(), sub.storage.edge_count()) == (
            n_nodes + 102, n_edges + 100), "writing procedures' counts"

        # a trigger fired by GDS_TRIGGERED creates
        call(sub, "CALL apoc.trigger.add('audit', 'UNWIND $createdNodes AS x "
             "CREATE (:Audit {of: x.k})', {label: 'Watched', "
             "event: 'create'}) YIELD name RETURN name")
        rows, t = call(sub, "UNWIND range(1, $n) AS i "
                       "CREATE (:Watched {k: i})", {"n": GDS_TRIGGERED})
        audit, _ = call(sub, "MATCH (a:Audit) RETURN count(a), sum(a.of)")
        fired, _ = call(sub, "CALL apoc.trigger.list() YIELD name, fired, "
                        "errors RETURN name, fired, errors")
        call(sub, "CALL apoc.trigger.remove('audit') YIELD name RETURN name")
        log(f"[phase16] (b) apoc.create / merge / refactor / periodic.iterate "
            f"with their counts; apoc.trigger.add fired by {GDS_TRIGGERED} "
            f"creates in {t:.2f}s: audit {audit}, {fired}")
        assert audit == [[GDS_TRIGGERED,
                          GDS_TRIGGERED * (GDS_TRIGGERED + 1) // 2]], audit
        assert fired == [["audit", GDS_TRIGGERED, 0]], fired

        # export with the gate set, import into another in-memory DB
        shutil.rmtree(APOC_DIR, ignore_errors=True)
        os.makedirs(APOC_DIR)
        path = os.path.join(APOC_DIR, "phase16.jsonl")
        gates = ("NORNICDB_APOC_EXPORT_ENABLED",
                 "NORNICDB_APOC_IMPORT_ENABLED")
        saved = {v: os.environ.get(v) for v in gates}
        os.environ.update({v: "1" for v in gates})
        try:
            rows, t_ex = call(sub, "CALL apoc.export.json.all($f, {}) YIELD "
                              "nodes, relationships RETURN nodes, "
                              "relationships", {"f": path})
            back, t_im = call(other, "CALL apoc.import.json($f) YIELD nodes, "
                              "relationships RETURN nodes, relationships",
                              {"f": path})
        finally:
            for v, val in saved.items():
                if val is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = val
        counts = [[sub.storage.node_count(), sub.storage.edge_count()]]
        log(f"[phase16] (b) apoc.export.json.all {rows} in {t_ex:.2f}s "
            f"({os.path.getsize(path)} bytes), apoc.import.json {back} in "
            f"{t_im:.2f}s; counts {counts} and "
            f"{[[other.storage.node_count(), other.storage.edge_count()]]}")
        assert rows == back == counts, (rows, back, counts)
        assert [[other.storage.node_count(),
                 other.storage.edge_count()]] == counts
        shutil.rmtree(APOC_DIR, ignore_errors=True)
    finally:
        for d in (mem, other, sub):
            d.close()


def phase_gds_apoc(K, db, seed: int) -> None:
    """Phase 16: GDS and APOC through ``db.cypher`` on the executor's
    device, after 10.9 and before phase 9. (a) over phase 10's DB, read
    only: ``gds.pageRank.stream`` over every node (phase 12's bounds
    against float64 over the snapshot's ``edge_arrays()``), ``gds.wcc``
    (scipy's components), ``gds.degree`` (``np.bincount``),
    ``adamicAdar.stream`` from GDS_SOURCES sources (``score_pair``'s
    ranking), ``apoc.path.expand`` (and ``apoc.neighbors.byhop`` from
    GDS_HOP_SOURCES of them) to depth 2 (a BFS),
    ``apoc.algo.pageRank(collect(i))`` over GDS_SUBSET ids, pure
    APOC functions over GDS_ROWS rows and the Kalman functions; node and
    edge counts equal before and after. (b) (``phase_gds_write``, in a
    card child beside 10.1's build) in-memory DBs on the same device:
    ``suggest`` (the GEMMs on the card) against the numpy branch, FastRP
    against a CPU executor, Louvain / SCC / k-core / triangles
    against ``graph_algos``, the graph catalog, betweenness and closeness
    on a subgraph, the writing procedures, a trigger and the export /
    import round trip. ``dbms.procedures()`` lists the new names. Logged:
    each call's wall time and the device time of the PageRank, WCC and
    GEMM calls (CUDA events). No kernel of the ``kernels`` line is on this
    path: its launches are read and logged."""
    rng = np.random.default_rng(seed + 16)
    names = {r[0] for r in db.cypher("CALL dbms.procedures() YIELD name "
                                     "RETURN name").rows}
    for want in ("gds.pagerank.stream", "gds.linkprediction.suggest",
                 "apoc.path.expand", "apoc.trigger.add"):
        assert want in names, want
    K.reset_launch_counts()
    with GraphDeviceTimes(db.device) as times:
        t0 = time.perf_counter()
        gds_read(db, rng, times)
        log(f"[phase16] (a) {time.perf_counter() - t0:.1f}s")
    log(f"[phase16] (a) kernel launches on this path: {K.launch_counts()} "
        f"(none expected: torch ops and torch.matmul)")


def phase_gds_write(K, seed: int) -> None:
    """Phase 16(b) (``gds_write``) on the card, in a card child: it reads
    nothing of phase 10's DB."""
    import torch

    device = torch.device("cuda")
    K.reset_launch_counts()
    with GraphDeviceTimes(device) as times:
        t0 = time.perf_counter()
        gds_write(device, seed, times)
        log(f"[phase16] (b) {time.perf_counter() - t0:.1f}s")
    log(f"[phase16] (b) kernel launches on this path: {K.launch_counts()} "
        f"(none expected: torch ops and torch.matmul)")


# ---------------------------------------------------------------- phase 15
def start_device_owner() -> None:
    """The process-default device owner, started before any consumer: it
    acquires the card on its own thread (CUDA init, a round trip) and
    probes it every probe_interval with a kernel on its own stream, under
    the port's one policy "fail". Every CUDA consumer of the run gates through
    it; phase 13 reads it."""
    from nornicdb_tpu_torch import backend

    mgr = backend.manager()
    t0 = time.perf_counter()
    assert mgr.await_ready(120.0), ("device owner", mgr.stats())
    OWNER["acquire_s"] = time.perf_counter() - t0
    OWNER["manager"] = mgr
    s = mgr.stats()
    log(f"[owner] the process-default device owner acquired the card in "
        f"{OWNER['acquire_s']:.2f}s: {json.dumps(s['device'])}, probe every "
        f"{s['probe_interval_s']}s, threshold "
        f"{mgr.probe_latency_threshold}s")


def probe_mark(tag: str) -> None:
    """Log the process-default owner's probes since the last mark: their
    count and largest latency. Phase 13 holds the largest of the run to
    half the threshold; this says in which phase it fell."""
    mgr = OWNER.get("manager")
    if mgr is None:
        return
    lat = list(mgr._latencies)
    seen = OWNER.get("marked", 0)
    new = lat[seen:] if seen <= len(lat) else lat
    OWNER["marked"] = len(lat)
    log(f"[owner] probes during {tag}: {len(new)}, max "
        f"{max(new) * 1e3 if new else 0.0:.3f}ms")


GDS_PAGERANK = ("CALL gds.pageRank.stream({maxIterations: 20}) "
                "YIELD node, score RETURN id(node), score")


def gds_executors(seed: int, mgr) -> tuple:
    """A Graph500 Kronecker graph of SCALE 10 in a MemoryEngine, an
    executor on the card behind ``mgr`` and one on the CPU."""
    from nornicdb_tpu_torch.cypher import CypherExecutor
    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    ks, kd = kronecker_edges(10, GRAPH_EDGEFACTOR, seed + 151)
    eng = MemoryEngine()
    for i in range(1 << 10):
        eng.create_node(Node(id=f"k{i}"))
    for e, (a, b) in enumerate(zip(ks.tolist(), kd.tolist())):
        eng.create_edge(Edge(id=f"ke{e}", start_node=f"k{a}",
                             end_node=f"k{b}"))
    return (CypherExecutor(eng, device="cuda", backend=mgr),
            CypherExecutor(eng, device="cpu"))


def phase_device_owner(seed: int) -> None:
    """Phase 15: the device owner's transitions on the card, with a
    private manager (the process default keeps serving). A
    ``BackendManager(hooks=FakeHooks("hang"), acquire_timeout=0.5)`` over
    an OWNER_ROWS x DIMS corpus on the card: a search raises
    DeviceUnavailable within 1.5 s; after ``set_mode("ok")`` the manager
    goes through RECOVERING to READY with one recovery, and the card
    answers with the ids a corpus of the same rows under the process
    default gave; a ``CypherExecutor`` behind the same manager refuses
    ``gds.pageRank.stream`` while it hangs and serves it on the card after
    the recovery (ranks within PR_L1_TOL of a CPU executor's). A second
    hang degrades the manager: a search raises at
    once, and a row written meanwhile is patched into the resident buffer
    after the second recovery (no whole-corpus upload), where the card
    finds it. A second private manager with the real hooks acquires the
    card and reports its name."""
    import torch

    from nornicdb_tpu_torch.backend import (
        DEGRADED_CPU,
        READY,
        RECOVERING,
        BackendManager,
        FakeHooks,
        RealHooks,
    )
    from nornicdb_tpu_torch.errors import DeviceUnavailable
    from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

    rng = np.random.default_rng(seed + 15)
    data = rng.standard_normal((OWNER_ROWS, DIMS), dtype=np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    ids = [f"o{i}" for i in range(OWNER_ROWS)]
    # each query's top 10 planted at cosines 0.95, 0.91, ..., 0.59: gaps
    # of 0.04, far above the card's bf16 scoring error, where random rows
    # stay under ~0.15
    qs = rng.standard_normal((OWNER_QUERIES, DIMS), dtype=np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    planted = rng.choice(OWNER_ROWS, (OWNER_QUERIES, 10), replace=False)
    for j in range(OWNER_QUERIES):
        for r, slot in enumerate(planted[j]):
            c = 0.95 - 0.04 * r
            w = data[slot] - (data[slot] @ qs[j]) * qs[j]
            w /= np.linalg.norm(w)
            data[slot] = c * qs[j] + np.sqrt(1 - c * c) * w
    ref = DeviceCorpus(dims=DIMS, device="cuda")  # the process default
    ref.add_batch(ids, data)
    card = ref.search(qs, k=10, exact=True)
    del ref
    card_ids = [[i for i, _ in r] for r in card]
    assert card_ids == [[ids[x] for x in planted[j]]
                        for j in range(OWNER_QUERIES)], (
        "the card's top 10 are the planted rows")

    def wait(mgr, state, limit):
        t0 = time.perf_counter()
        while mgr.state != state and time.perf_counter() - t0 < limit:
            time.sleep(0.005)
        assert mgr.state == state, (state, mgr.stats())
        return time.perf_counter() - t0

    def refused(c) -> tuple[float, str]:
        t0 = time.perf_counter()
        try:
            c.search(qs, k=10, exact=True)
        except DeviceUnavailable as e:
            return time.perf_counter() - t0, str(e)
        raise AssertionError("a card that is not serving answered")

    hooks = FakeHooks("hang")
    mgr = BackendManager(hooks=hooks, acquire_timeout=0.5,
                         probe_interval=0.1, probe_timeout=0.3,
                         recover_after=2)
    try:
        c = DeviceCorpus(dims=DIMS, device="cuda", backend=mgr)
        c.add_batch(ids, data)
        t_fail, err = refused(c)
        assert t_fail < 1.5, ("DeviceUnavailable took", t_fail)
        wait(mgr, DEGRADED_CPU, 2)  # the acquire thread's own timeout
        t_again, _ = refused(c)
        assert t_again < 0.05, ("a degraded owner made a caller wait",
                                t_again)
        # a Cypher executor behind the same owner: GDS is refused too
        ex, cpu_ex = gds_executors(seed, mgr)
        t0 = time.perf_counter()
        try:
            ex.execute(GDS_PAGERANK)
            raise AssertionError("gds.pageRank.stream on a hung owner")
        except DeviceUnavailable:
            t_gds = time.perf_counter() - t0
        hooks.set_mode("ok")
        t_recover = wait(mgr, READY, 10)
        path = [t["to"] for t in mgr.stats()["transitions"]]
        assert path[-2:] == [RECOVERING, READY], path
        assert mgr.counters.recoveries == 1, mgr.counters
        got = {r[0]: r[1] for r in ex.execute(GDS_PAGERANK).rows}
        want = {r[0]: r[1] for r in cpu_ex.execute(GDS_PAGERANK).rows}
        assert got.keys() == want.keys()
        l1_gds = float(sum(abs(got[k] - want[k]) for k in want))
        assert l1_gds <= PR_L1_TOL, ("gds.pageRank.stream after recovery",
                                     l1_gds)
        log(f"[phase15] an executor behind the hung owner refused "
            f"gds.pageRank.stream with DeviceUnavailable in {t_gds:.4f}s; "
            f"after the recovery it served it on the card, L1 {l1_gds:.3e} "
            f"to a CPU executor's ranks over {len(want)} nodes")
        t0 = time.perf_counter()
        got = c.search(qs, k=10, exact=True)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        assert [[i for i, _ in r] for r in got] == card_ids, (
            "the card after recovery")
        fulls = c.sync_stats.full_uploads
        # a second hang: the probes fail, the owner degrades, and a row
        # overwritten meanwhile (an unplanted row set to query 0 itself)
        # lands on the host only
        hooks.set_mode("hang")
        t_degrade = wait(mgr, DEGRADED_CPU, 10)
        t_refused, _ = refused(c)
        assert t_refused < 0.05, t_refused
        taken = set(planted.ravel().tolist())
        spare = ids[next(i for i in range(OWNER_ROWS) if i not in taken)]
        c.add(spare, qs[0])
        hooks.set_mode("ok")
        t_recover2 = wait(mgr, READY, 10)
        assert mgr.counters.recoveries == 2, mgr.counters
        got = c.search(qs, k=10, exact=True)
        assert [i for i, _ in got[0]] == [spare] + card_ids[0][:9], got[0]
        assert [[i for i, _ in r] for r in got[1:]] == card_ids[1:]
        assert c.sync_stats.full_uploads == fulls, c.sync_stats
        log(f"[phase15] private owner over FakeHooks('hang') and "
            f"{OWNER_ROWS}x{DIMS} on the card: a search raised "
            f"DeviceUnavailable in {t_fail:.3f}s ({err!r}), {t_again:.4f}s "
            f"once degraded; set_mode('ok') -> {' -> '.join(path)} in "
            f"{t_recover:.2f}s, recoveries 1; the card answered "
            f"{OWNER_QUERIES} queries in {t_card:.3f}s with the reference "
            f"ids. A second hang degraded it in {t_degrade:.2f}s (a search "
            f"raised in {t_refused:.4f}s); a row written meanwhile was "
            f"patched in after the recovery ({t_recover2:.2f}s, recoveries "
            f"{mgr.counters.recoveries}, whole-corpus uploads still "
            f"{fulls}, patches {c.sync_stats.patches}) and ranks first for "
            f"its query; no request was served from the host")
    finally:
        mgr.stop()
    real = BackendManager(hooks=RealHooks(), acquire_timeout=30.0)
    try:
        t0 = time.perf_counter()
        assert real.await_ready(), real.stats()
        info = real.stats()["device"]
        log(f"[phase15] a second private owner with the real hooks "
            f"acquired {json.dumps(info)} in {time.perf_counter() - t0:.2f}s")
        assert info["name"] == torch.cuda.get_device_name(0), info
    finally:
        real.stop()


class _HttpClient:
    """One keep-alive HTTP/1.1 connection that answers a 429 as a client
    does: it waits the response's ``Retry-After`` and asks again (at most
    BACKOFF_TRIES times). ``sheds`` (shared by the phase's clients) counts
    the 429s and the longest run of them one request met."""

    def __init__(self, port: int, sheds: dict, headers=None):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.sheds = sheds
        self.headers = {"Content-Type": "application/json", **(headers or {})}

    def call(self, method: str, path: str, body=None):
        """(status, parsed body or text, seconds); 429s retried."""
        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        for run in range(1, BACKOFF_TRIES + 1):
            self.conn.request(method, path, body=data, headers=self.headers)
            resp = self.conn.getresponse()
            raw = resp.read()
            if resp.status != 429 or run == BACKOFF_TRIES:
                break
            with self.sheds["mu"]:
                self.sheds["n"] += 1
                self.sheds["longest"] = max(self.sheds["longest"], run)
            time.sleep(float(resp.getheader("Retry-After") or 1))
        kind = resp.getheader("Content-Type") or ""
        out = json.loads(raw) if "json" in kind else raw.decode()
        return resp.status, out, time.perf_counter() - t0

    def close(self) -> None:
        self.conn.close()


class _BoltClient:
    """A Bolt 4.4 session over a socket (HELLO, RUN, PULL, RESET); a
    statement the serving engines shed (the transient ResourceExhausted
    code, the 429 of the Bolt edge) is asked again after a RESET and a
    second's wait, counted in ``sheds``."""

    def __init__(self, port: int, sheds: dict):
        import socket
        import struct

        from nornicdb_tpu_torch.server.packstream import Structure, pack, unpack

        self._struct, self._S, self._pack, self._unpack = (
            struct, Structure, pack, unpack)
        self.sheds = sheds
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.sock.sendall(b"\x60\x60\xb0\x17"
                          + struct.pack(">I", (4 << 0) | (4 << 8))
                          + b"\x00" * 12)
        self._exact(4)

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("bolt connection closed")
            buf += part
        return buf

    def _message(self):
        chunks = b""
        while True:
            (size,) = self._struct.unpack(">H", self._exact(2))
            if size == 0:
                return self._unpack(chunks)
            chunks += self._exact(size)

    def send(self, tag: int, fields: list):
        payload = self._pack(self._S(tag, fields))
        self.sock.sendall(self._struct.pack(">H", len(payload)) + payload
                          + b"\x00\x00")
        return self._message()

    def hello(self, meta: dict):
        return self.send(0x01, [meta])

    def run(self, query: str, params: dict) -> list:
        """RUN + PULL: the records' rows; a FAILURE raises, but a shed is
        retried."""
        for run in range(1, BACKOFF_TRIES + 1):
            msg = self.send(0x10, [query, params, {}])
            if msg.tag == 0x70:
                out, msg = [], self.send(0x3F, [{"n": -1}])
                while msg.tag == 0x71:
                    out.append(msg.fields[0])
                    msg = self._message()
                assert msg.tag == 0x70, msg
                return out
            code = msg.fields[0].get("code", "")
            assert self.send(0x0F, []).tag == 0x70  # RESET
            if code != "Neo.TransientError.Request.ResourceExhausted" or (
                    run == BACKOFF_TRIES):
                raise AssertionError(("bolt failure", msg.fields[0]))
            with self.sheds["mu"]:
                self.sheds["n"] += 1
                self.sheds["longest"] = max(self.sheds["longest"], run)
            time.sleep(1.0)
        raise AssertionError("unreachable")

    def close(self) -> None:
        self.sock.close()


def _launch_delta(K, before: dict) -> dict:
    now = K.launch_counts()
    return {name: now[name] - before.get(name, 0) for name in now}


def _pcts(xs) -> str:
    ms = np.asarray(xs) * 1e3
    return (f"p50 {np.median(ms):.2f}ms p99 {np.percentile(ms, 99):.2f}ms"
            if len(ms) else "none")


def phase_serve(K, db, served: dict, seed: int) -> None:
    """Phase 17(a): the port's ``HttpServer`` and ``BoltServer`` over phase
    10's DB (phase 8's engine as its embedder, phase 9's checkpoint behind
    Heimdall), wired as ``cmd_serve`` wires them. SERVE_CLIENTS HTTP
    clients send SERVE_VECTORS raw-vector searches, SERVE_TEXTS text
    searches, SERVE_TX transaction-API reads and SERVE_RAG GraphRAG
    answers, mixed in a seeded order; beside them SERVE_CLIENTS Bolt
    sessions make SERVE_BOLT ``queryNodes`` calls.
    Each answer is held, with no writer active, to the DB: a raw-vector
    body to a fresh ``vector_candidates`` call's ids (scores within #2's
    decode step), and, as a check of the route's serialisation, exactly
    to the answer (recorded) of the call that served it; a
    text body to ``db.search.search`` (rank cache cleared) in ids and
    scores; the Bolt and transaction rows to ``db.cypher`` (query cache
    cleared) in ids, scores within #2's decode step; a GraphRAG answer
    paged, with its own node among the sources. A 429 is retried after its
    Retry-After. Then the admin GETs, each timed, ``/metrics`` parsed
    strictly, ``/graphql``'s node count; each kernel's launches in the
    phase, #2 and #5 above 0."""
    import torch

    from nornicdb_tpu_torch.ops.kernels import pick_tile_n, streaming_geometry
    from nornicdb_tpu_torch.server import BoltServer, HttpServer

    rng = np.random.default_rng(seed + 17)
    texts, embs = served["texts"], served["embs"]
    svc = db.search
    eng = db.genserve_engine()
    assert eng is not None, "phase 9's engine is not mounted"
    tokens0 = eng.stats.generated_tokens
    http = HttpServer(db, host="127.0.0.1", port=0)
    http.start()
    bolt = BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(
            q, p),
        host="127.0.0.1", port=0,
        session_executor_factory=db.session_executor)
    bolt.start()
    # what the service answered each vector_candidates call of the servers
    answered: dict = {}
    mu = threading.Lock()
    inner = svc.vector_candidates

    def recording(embedding, k=10, min_similarity=-1.0):
        out = inner(embedding, k, min_similarity)
        with mu:
            answered[(np.asarray(embedding, np.float32).tobytes(), k)] = out
        return out

    def noisy(rows):
        return (embs[rows] + 0.01 * rng.standard_normal(
            (len(rows), embs.shape[1]))).astype(np.float32)

    q_nodes = ("CALL db.index.vector.queryNodes('default', $k, $v) "
               "YIELD node, score RETURN node.id, score")
    vec_rows = rng.choice(len(embs), SERVE_VECTORS, replace=False)
    vecs = noisy(vec_rows)
    queries: list = []
    for r in rng.permutation(len(texts)):
        q = " ".join(texts[r].split()[-3:])  # the last word is unique
        if q not in queries:
            queries.append(q)
        if len(queries) == SERVE_TEXTS:
            break
    tx_vecs = noisy(rng.choice(len(embs), SERVE_TX, replace=False))
    rag_rows = rng.choice(len(texts), SERVE_RAG, replace=False)
    bolt_vecs = noisy(rng.choice(len(embs), SERVE_BOLT, replace=False))
    # the searches, reads and GraphRAG answers, mixed in a seeded order
    work = ([("vector", i) for i in range(SERVE_VECTORS)]
            + [("text", i) for i in range(SERVE_TEXTS)]
            + [("tx", i) for i in range(SERVE_TX)]
            + [("rag", i) for i in range(SERVE_RAG)])
    order = rng.permutation(len(work))
    got: dict = {}
    lat: dict = {"vector": [], "text": [], "tx": [], "rag": [], "bolt": []}
    sheds = {"n": 0, "longest": 0, "mu": threading.Lock()}
    errors: list = []

    def http_client(c: int, items: list) -> None:
        cl = _HttpClient(http.port, sheds)
        try:
            for kind, i in items:
                if kind == "vector":
                    req = ("/nornicdb/search", {
                        "vector": vecs[i].tolist(), "limit": SERVE_K})
                elif kind == "text":
                    req = ("/nornicdb/search",
                           {"query": queries[i], "limit": SERVE_K})
                elif kind == "tx":
                    req = ("/db/neo4j/tx/commit", {"statements": [{
                        "statement": q_nodes,
                        "parameters": {"k": SERVE_K,
                                       "v": tx_vecs[i].tolist()}}]})
                else:
                    req = ("/nornicdb/rag/answer",
                           {"question": texts[rag_rows[i]]})
                code, body, dt = cl.call("POST", *req)
                assert code == 200, (kind, i, code, body)
                got[(kind, i)] = body
                with mu:
                    lat[kind].append(dt)
        except Exception as e:  # re-raised on the main thread
            errors.append(e)
        finally:
            cl.close()

    def bolt_client(c: int) -> None:
        try:
            cl = _BoltClient(bolt.port, sheds)
            try:
                assert cl.hello({"scheme": "none",
                                 "user_agent": "chip_smoke/17"}).tag == 0x70
                for i in range(c, SERVE_BOLT, SERVE_CLIENTS):
                    t = time.perf_counter()
                    got[("bolt", i)] = cl.run(q_nodes, {
                        "k": SERVE_K, "v": bolt_vecs[i].tolist()})
                    with mu:
                        lat["bolt"].append(time.perf_counter() - t)
            finally:
                cl.close()
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    c0 = K.launch_counts()
    ivf0 = ivf_dispatches()
    svc.vector_candidates = recording
    try:
        t0 = time.perf_counter()
        threads = ([threading.Thread(target=http_client, args=(
            c, [work[j] for j in order[c::SERVE_CLIENTS]]))
            for c in range(SERVE_CLIENTS)]
            + [threading.Thread(target=bolt_client, args=(c,))
               for c in range(SERVE_CLIENTS)])
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not any(th.is_alive() for th in threads), "a client hung"
        wall = time.perf_counter() - t0
        launches = _launch_delta(K, c0)
        ivf = ivf_dispatches() - ivf0
        if errors:
            raise errors[0]
        n_req = sum(len(v) for v in lat.values())
        log(f"[phase17] (a) {n_req} requests from {SERVE_CLIENTS} HTTP "
            f"clients and {SERVE_CLIENTS} Bolt sessions, the "
            f"{SERVE_RAG} GraphRAG answers among the searches, over "
            f"{db.storage.node_count()} nodes x {embs.shape[1]} in "
            f"{wall:.2f}s ({n_req / wall:.1f} requests/s): "
            + "; ".join(f"{k} {_pcts(v)} ({len(v)})" for k, v in lat.items())
            + f"; 429s retried {sheds['n']}, longest run {sheds['longest']}; "
            f"launches in the traffic {json.dumps(launches)}; IVF-pruned "
            f"searches {ivf:.0f}")
    finally:
        del svc.vector_candidates  # the bound method again
    try:
        # -- the answers, held to the DB with no writer active
        t0 = time.perf_counter()
        cap = svc.corpus().capacity
        tile_bits = streaming_geometry(cap, pick_tile_n(cap), 1)[2]
        score_tol = 2.0 ** (tile_bits - 22)
        diff = 0.0
        for i in range(SERVE_VECTORS):
            body = got[("vector", i)]["results"]
            want = answered[(vecs[i].tobytes(), SERVE_K)]
            assert [(r["id"], r["score"]) for r in body] == [
                (a, b) for a, b in want], ("vector body", i)
            assert all(r["content"] == db.storage.get_node(r["id"])
                       .properties.get("content", "") for r in body)
            fresh = inner(vecs[i], SERVE_K)
            assert [r["id"] for r in body] == [a for a, _ in fresh], (
                "vector ids", i)
            diff = max(diff, max(abs(r["score"] - b)
                                 for r, (_, b) in zip(body, fresh)))

        def cypher_rows(params):
            db.query_cache.clear()  # an answer the servers cached is not one
            return db.cypher(q_nodes, params).rows

        for kind, vs, pick in (
                ("tx", tx_vecs,
                 lambda b: [d["row"] for d in b["results"][0]["data"]]),
                ("bolt", bolt_vecs, lambda b: b)):
            for i in range(len(vs)):
                rows = pick(got[(kind, i)])
                if kind == "tx":
                    assert not got[(kind, i)]["errors"], got[(kind, i)]
                want = cypher_rows({"k": SERVE_K, "v": vs[i].tolist()})
                assert [r[0] for r in rows] == [w[0] for w in want], (
                    kind, i)
                diff = max(diff, max(abs(r[1] - w[1])
                                     for r, w in zip(rows, want)))
        assert diff <= score_tol, ("scores", diff, score_tol)
        with svc._lock:
            svc._rank_cache.clear()
        text_ref: list = [None] * SERVE_TEXTS

        def ref_client(c: int) -> None:
            try:
                for i in range(c, SERVE_TEXTS, SERVE_CLIENTS):
                    text_ref[i] = _Backoff()(svc.search, queries[i],
                                             limit=SERVE_K)
            except Exception as e:  # re-raised on the main thread
                errors.append(e)

        threads = [threading.Thread(target=ref_client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errors:
            raise errors[0]
        for i in range(SERVE_TEXTS):
            body = got[("text", i)]["results"]
            assert body, ("no text results", queries[i])
            assert [(r["id"], r["score"], r["content"]) for r in body] == [
                (w["id"], w["score"], w["content"]) for w in text_ref[i]], (
                "text body", i, queries[i])
        for i, r in enumerate(rag_rows):
            a = got[("rag", i)]
            assert a["mode"] == "paged", a["mode"]
            assert f"t{r}" in [src["id"] for src in a["sources"]], (
                "own node not retrieved", i)
            assert a["generated_tokens"] >= 1, a
        log(f"[phase17] (a) checks {time.perf_counter() - t0:.2f}s: "
            f"{SERVE_VECTORS} raw-vector bodies serialise the "
            f"vector_candidates answer that served them (ids, scores) and "
            f"name a fresh call's ids; "
            f"{SERVE_TX} transaction and {SERVE_BOLT} Bolt answers equal to "
            f"db.cypher in ids; max |score - reference| {diff:.6g} (bound: "
            f"#2's decode step {score_tol:.6g} at capacity {cap}); "
            f"{SERVE_TEXTS} text bodies equal to db.search.search in ids, "
            f"scores and content; {SERVE_RAG} GraphRAG answers paged, each "
            f"with its own node, tokens "
            f"{[got[('rag', i)]['generated_tokens'] for i in range(SERVE_RAG)]}")
        assert launches["streaming_topk_bf16"] > 0, "the servers missed #2"
        assert launches["ragged_paged_attention"] > 0, "the RAG route missed #5"
        assert ivf == 0, ("an IVF plan served", ivf)

        # -- the admin surface, each GET timed
        cl = _HttpClient(http.port, sheds)
        try:
            times = {}
            for path in ("/health", "/metrics", "/admin/stats",
                         "/admin/stats", "/admin/tpu/status",
                         "/openapi.json"):
                code, body, dt = cl.call("GET", path)
                assert code == 200, (path, code)
                # the first /admin/stats builds the system database's
                # namespaced view (a scan of every node and edge, once)
                times[path if path not in times else path + " again"] = dt
                if path == "/metrics":
                    fams = parse_exposition(body)
                    for fam in ("nornicdb_http_request_seconds",
                                "nornicdb_bolt_request_seconds",
                                "nornicdb_requests_total",
                                "nornicdb_broker_requests_total",
                                "nornicdb_worker_requests_total",
                                "nornicdb_shm_publishes_total",
                                "heimdall_chat_requests"):
                        assert fam in fams, fam
                    served_2xx = sample_total(
                        fams, "nornicdb_http_requests_by_code_total", "",
                        method="POST", code="200")
                    assert served_2xx >= len(work), served_2xx
                elif path == "/admin/stats":
                    assert body["nodes"] == db.storage.node_count()
                    assert {"search", "genserve", "serving", "wal",
                            "databases", "backend"} <= set(body), sorted(body)
                    stats_keys = sorted(body)
                elif path == "/admin/tpu/status":
                    assert body["framework"] == "torch"
                    assert body["backend_initialized"] is True
                    assert body["devices"][0] == torch.cuda.get_device_name(0)
                    assert body["lifecycle"]["state"] == "READY", body
                    status = body
                elif path == "/openapi.json":
                    assert "/db/{database}/tx/commit" in body["paths"] or any(
                        "tx/commit" in p for p in body["paths"])
            code, body, _ = cl.call("POST", "/graphql",
                                    {"query": "{ stats { nodes } }"})
            assert code == 200 and body == {"data": {"stats": {
                "nodes": db.storage.node_count()}}}, (code, body)
        finally:
            cl.close()
        log(f"[phase17] (a) admin GETs: "
            + ", ".join(f"{p} {t * 1e3:.2f}ms" for p, t in times.items())
            + f"; /metrics parsed strictly ({len(fams)} families); "
            f"/admin/stats sections {stats_keys}; /admin/tpu/status "
            f"devices {status['devices']} kernel launches "
            f"{json.dumps(status['kernel_launches'])}; /graphql stats "
            f"{body['data']['stats']}")
    finally:
        bolt.stop()
        http.stop()
        GEN_COUNTED["17"] = eng.stats.generated_tokens - tokens0


# phase 17(b)'s serving child: ``cli.main(["serve", ...])``, as ``python
# -m nornicdb_tpu_torch serve`` calls it, once the streaming threshold is
# lowered to its SERVE_DOCS-row corpus (the module constant, as
# tests/test_torch_cuda.py lowers it), so its searches run #2
SERVE_LAUNCHER = (
    "import sys\n"
    "from nornicdb_tpu_torch.ops import similarity\n"
    "similarity.STREAMING_MIN_ROWS = int(sys.argv[1])\n"
    "from nornicdb_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[2:]))\n")


class ServeChildren:
    """Phase 17(b)'s two children, started after 17(a) so that nothing
    else boots a CUDA context while it serves: ``serve --auth --embedder
    hash`` over a fresh data directory through SERVE_LAUNCHER, with
    ``NORNICDB_GRPC_ENABLED`` and ``NORNICDB_QDRANT_GRPC_ENABLED`` on free
    ports, and ``python -m nornicdb_tpu_torch serve --workers 2``, which
    must refuse to start (prefork workers, ROADMAP A6d). ``start_decay``
    runs ``python -m nornicdb_tpu_torch decay recalculate`` then ``decay
    stats`` over (b)'s data directory in the background (main starts them
    beside phase 10's close, host-bound JSON with the card idle), and
    ``collect_decay`` reads them. ``close`` kills what still runs and
    deletes the directory."""

    def __init__(self):
        import tempfile

        self.here = os.path.dirname(os.path.abspath(__file__))
        scratch = os.path.join(self.here, ".chip_scratch")
        os.makedirs(scratch, exist_ok=True)
        self.work = tempfile.mkdtemp(prefix="serve17-", dir=scratch)
        self.data = os.path.join(self.work, "data")
        self.err_path = os.path.join(self.work, "serve.err")
        self.pw = "chip-smoke-17"
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith("NORNICDB_")}
        self.env.update(NORNICDB_ADMIN_PASSWORD=self.pw)
        self.args = ["serve", "--auth", "--embedder", "hash",
                     "--embed-dims", str(SERVE_DIMS), "--host", "127.0.0.1",
                     "--http-port", "0", "--bolt-port", "0"]
        self.proc = self.refused = self.decay_proc = None
        self.decay_thread = None
        self.decay_out: list = []

    def start(self) -> "ServeChildren":
        self.t0 = time.perf_counter()
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", SERVE_LAUNCHER, str(SERVE_DOCS)]
                + self.args + ["--data-dir", self.data], cwd=self.here,
                env=dict(self.env, NORNICDB_GRPC_ENABLED="1",
                         NORNICDB_QDRANT_GRPC_ENABLED="1",
                         NORNICDB_GRPC_PORT="0",
                         NORNICDB_QDRANT_GRPC_PORT="0"),
                text=True, stdout=subprocess.PIPE, stderr=err)
        self.refused = subprocess.Popen(
            [sys.executable, "-m", "nornicdb_tpu_torch"] + self.args
            + ["--workers", "2", "--data-dir", self.data + "-refused"],
            cwd=self.here, env=self.env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        return self

    def start_decay(self) -> None:
        """``decay recalculate`` then ``decay stats`` over the served data
        directory, one process each, on a thread of their own."""

        def run() -> None:
            for action in ("recalculate", "stats"):
                t0 = time.perf_counter()
                self.decay_proc = subprocess.Popen(
                    [sys.executable, "-m", "nornicdb_tpu_torch",
                     "--data-dir", self.data, "decay", action],
                    cwd=self.here, env=self.env, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                out, err = self.decay_proc.communicate(timeout=600)
                self.decay_out.append((action, self.decay_proc.returncode,
                                       out, err[-3000:],
                                       time.perf_counter() - t0))

        self.t_decay = time.perf_counter()
        self.decay_thread = threading.Thread(target=run, daemon=True)
        self.decay_thread.start()

    def collect_decay(self, nodes: int) -> str:
        """Wait for the two commands: both exit 0, ``recalculate`` scores
        the ``nodes`` nodes of the served database and archives none (all
        were accessed minutes ago), ``stats`` prints the manager's
        counters as JSON (a new process's manager: all 0). Returns a log
        line."""
        t0 = time.perf_counter()
        self.decay_thread.join(timeout=600)
        waited = time.perf_counter() - t0
        assert len(self.decay_out) == 2, self.decay_out
        (a1, rc1, out1, err1, s1), (a2, rc2, out2, err2, s2) = self.decay_out
        assert rc1 == 0 and rc2 == 0, (rc1, err1, rc2, err2)
        assert out1.strip().splitlines()[-1] == (
            f"scored {nodes} nodes, archived 0"), out1
        stats = json.loads(out2.strip().splitlines()[-1])
        assert stats == {"recalculations": 0, "nodes_scored": 0,
                         "archived": 0, "reinforced": 0}, stats
        return (f"python -m nornicdb_tpu_torch decay recalculate "
                f"({s1:.1f}s): {out1.strip().splitlines()[-1]!r}; decay "
                f"stats ({s2:.1f}s): {json.dumps(stats)}; both in the "
                f"background beside phase 10's close, waited "
                f"{waited:.1f}s for them after it")

    def close(self) -> None:
        import shutil

        for p in (self.proc, self.refused, self.decay_proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def qdrant_search_request(coll: str, vec, limit: int, group=None) -> bytes:
    """A Qdrant gRPC SearchPoints (collection_name=1, vector=2, filter=3 on
    a group's integer match, limit=4), hand-encoded as the port's
    qdrant_grpc encodes it."""
    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    req = Q._s(1, coll) + Q._packed_f32(2, [float(x) for x in vec])
    if group is not None:
        cond = Q._ld(1, Q._s(1, "group") + Q._ld(2, Q._vi(2, int(group))))
        req += Q._ld(3, Q._ld(2, cond))
    return req + Q._vi(4, limit)


def qdrant_hits(raw: bytes) -> list:
    """A SearchResponse's ScoredPoints as REST's shape (id, score, payload;
    the score the wire's float32)."""
    import struct

    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    out = []
    for _, hit in Q._parse(raw).get(1, []):
        f = Q._parse(hit)
        out.append({"id": Q.dec_point_id(f[1][0][1]),
                    "score": struct.unpack("<f", f[3][0][1])[0],
                    "payload": Q.dec_payload_map(f.get(2, []))})
    return out


def qdrant_points(raw: bytes, field: int) -> list:
    """The RetrievedPoints at ``field`` of a Get (1) or Scroll (2)
    response: id, payload, vector."""
    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    out = []
    for _, p in Q._parse(raw).get(field, []):
        f = Q._parse(p)
        out.append({"id": Q.dec_point_id(f[1][0][1]),
                    "payload": Q.dec_payload_map(f.get(2, [])),
                    "vector": Q.dec_vectors(f[4][0][1]) if 4 in f else None})
    return out


def qdrant_upsert_request(coll: str, ids, vecs, payloads) -> bytes:
    """An UpsertPoints of ``ids`` (PointStruct id=1, payload=3,
    vectors=4)."""
    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    # Vectors{vector=1 Vector{data=1}}: the packed floats are their
    # little-endian float32 bytes, as Q._packed_f32 writes them
    return Q._s(1, coll) + b"".join(
        Q._ld(3, Q._ld(1, Q.enc_point_id(int(i)))
              + Q.enc_payload_map(3, p)
              + Q._ld(4, Q._ld(1, Q._ld(1, np.asarray(v, "<f4").tobytes()))))
        for i, v, p in zip(ids, vecs, payloads))


def serve_grpc_searches(port: int, queries: list, http_answers: list):
    """17(b)'s native gRPC searches: ``queries`` ((kind, input), kind
    "vector" or "text") over SERVE_CLIENTS clients at once, each on a
    ``grpcwire.Channel`` of its own. Each answer's ids, content and scores
    equal the HTTP ``/nornicdb/search`` answer for the same input in
    ``http_answers`` (the scores at the wire's float32, the type of
    SearchHit.score). Returns (wall seconds, latencies)."""
    from nornicdb_tpu_torch.server import grpcwire
    from nornicdb_tpu_torch.server.grpc_search import search_over_grpc

    got, lat, mu = {}, [], threading.Lock()

    def client(c: int) -> None:
        with grpcwire.Channel("127.0.0.1", port) as ch:
            for j in range(c, len(queries), SERVE_CLIENTS):
                kind, x = queries[j]
                t = time.perf_counter()
                out = search_over_grpc(
                    "127.0.0.1", port, limit=5, channel=ch,
                    **({"vector": x} if kind == "vector" else {"query": x}))
                with mu:
                    lat.append(time.perf_counter() - t)
                    got[j] = out

    t0 = time.perf_counter()
    in_threads(client, list(range(SERVE_CLIENTS)), SERVE_CLIENTS)
    wall = time.perf_counter() - t0
    for j, want in enumerate(http_answers):
        hits = got[j]["hits"]
        assert [h["id"] for h in hits] == [r["id"] for r in want], (
            "gRPC ids", queries[j][0], j)
        assert [h["content"] for h in hits] == [r["content"] for r in want]
        assert [h["score"] for h in hits] == [
            float(np.float32(r["score"])) for r in want], ("gRPC scores", j)
    return wall, lat


def serve_qdrant_grpc(http_port: int, port: int, token: str, pw: str,
                      sheds: dict) -> str:
    """17(b)'s Qdrant gRPC service with ``--auth``: no credentials ->
    UNAUTHENTICATED; a viewer's Upsert -> PERMISSION_DENIED (its Count
    answers); an admin's bearer token creates a collection and upserts,
    its basic auth upserts too; the points are seen over REST
    ``/collections/*`` (count, a search answering its own point first),
    and a REST write is seen over gRPC (Count, Get with vectors as
    written). Returns a log line."""
    import base64

    from nornicdb_tpu_torch.server import grpcwire
    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    rng = np.random.default_rng(SERVE_DOCS)
    n = SERVE_QDRANT_POINTS
    vecs = rng.standard_normal((n, SERVE_DIMS)).astype(np.float32)

    def basic(user: str, secret: str) -> list:
        return [("authorization", "Basic " + base64.b64encode(
            f"{user}:{secret}".encode()).decode())]

    bearer = [("authorization", f"Bearer {token}")]
    t0 = time.perf_counter()
    with grpcwire.Channel("127.0.0.1", port) as ch:
        def call(method, req, md=None):
            return ch.unary_unary(method)(req, timeout=60, metadata=md)

        def refused(method, req, md, code) -> None:
            try:
                call(method, req, md)
            except grpcwire.RpcError as e:
                assert e.code() == code, (method, e.code(), e.details())
                return
            raise AssertionError((method, "answered", code))

        refused("/qdrant.Collections/List", b"", None,
                grpcwire.StatusCode.UNAUTHENTICATED)
        cfg = Q._ld(1, Q._vi(1, SERVE_DIMS) + Q._vi(2, 1))
        made = Q._parse(call("/qdrant.Collections/Create",
                             Q._s(1, "q17") + Q._ld(10, cfg), bearer))
        assert made[1][0][1] == 1, made
        half = n // 2
        payloads = [{"i": i} for i in range(n)]
        call("/qdrant.Points/Upsert", qdrant_upsert_request(
            "q17", range(half), vecs[:half], payloads[:half]), bearer)
        refused("/qdrant.Points/Upsert", qdrant_upsert_request(
            "q17", [half], vecs[half:half + 1], payloads[half:half + 1]),
            basic("viewer", "viewer-pw"),
            grpcwire.StatusCode.PERMISSION_DENIED)
        seen = Q._parse(call("/qdrant.Points/Count", Q._s(1, "q17"),
                             basic("viewer", "viewer-pw")))
        assert Q._parse(seen[1][0][1])[1][0][1] == half, seen
        three = 3 * n // 4
        call("/qdrant.Points/Upsert", qdrant_upsert_request(
            "q17", range(half, three), vecs[half:three],
            payloads[half:three]), basic("admin", pw))
        cl = _HttpClient(http_port, sheds, {"Authorization":
                                            f"Bearer {token}"})
        try:
            code, info, _ = cl.call("GET", "/collections/q17")
            assert code == 200 and info["result"]["points_count"] == three
            for i in (0, three - 1):
                code, out, _ = cl.call(
                    "POST", "/collections/q17/points/search",
                    {"vector": vecs[i].tolist(), "limit": 3})
                assert code == 200 and out["result"][0]["id"] == i, out
                assert out["result"][0]["payload"] == {"i": i}
            code, out, _ = cl.call("PUT", "/collections/q17/points", {
                "points": [{"id": i, "vector": vecs[i].tolist(),
                            "payload": {"i": i}} for i in range(three, n)]})
            assert code == 200 and out["result"]["upserted"] == n - three
        finally:
            cl.close()
        count = Q._parse(call("/qdrant.Points/Count", Q._s(1, "q17"),
                              bearer))
        assert Q._parse(count[1][0][1])[1][0][1] == n, count
        got = qdrant_points(call("/qdrant.Points/Get", Q._s(1, "q17") + b"".join(
            Q._ld(2, Q.enc_point_id(i)) for i in range(three, n)), bearer), 1)
        assert [p["id"] for p in got] == list(range(three, n)), got
        for p in got:
            assert p["payload"] == {"i": p["id"]}
            assert np.array_equal(np.asarray(p["vector"], np.float32),
                                  vecs[p["id"]]), p["id"]
        hits = qdrant_hits(call("/qdrant.Points/Search", qdrant_search_request(
            "q17", vecs[n - 1], 3), bearer))
        assert hits[0]["id"] == n - 1, hits
    return (f"Qdrant gRPC with --auth: no credentials UNAUTHENTICATED, a "
            f"viewer's Upsert PERMISSION_DENIED (its Count {half}), "
            f"{half} points upserted with an admin's bearer token and "
            f"{three - half} with basic auth, seen over REST (count "
            f"{three}, searches answering their own point first), "
            f"{n - three} written over REST seen over gRPC (Count {n}, Get "
            f"with vectors as written, a search); "
            f"{time.perf_counter() - t0:.2f}s")


def phase_serve_cli(K, children: ServeChildren) -> None:
    """Phase 17(b), over ``children`` (started after 17(a)): /health; an
    unauthenticated search gets 401; a login's token stores SERVE_DOCS
    documents through the transaction API and, once the embed worker has
    embedded them, searches by vector and by text answer each document
    first, through #2 (the child's own launch counts, read from
    /admin/tpu/status, which also names the card); ``/graphql`` counts the
    documents, ``GET /collections`` lists none, and a viewer's GraphQL
    mutation is refused (401, "permission write denied", the JAX server's
    answer); a Bolt HELLO with a wrong password gets Unauthorized, the
    right one SUCCESS and a count; the native gRPC search (SERVE_CLIENTS
    clients, a ``grpcwire.Channel`` each: the HTTP searches' vectors and
    texts, each answer equal to HTTP's, #2 launched by them) and the
    Qdrant gRPC service with ``--auth`` (``serve_qdrant_grpc``); SIGTERM
    ends it with 0 within SERVE_EXIT_S and a reopen finds every document.
    The start with ``--workers 2`` exited non-zero naming ROADMAP A6d, and
    created no data directory."""
    import select
    import signal

    import torch

    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.embed import HashEmbedder

    c = children
    proc, pw = c.proc, c.pw
    sheds = {"n": 0, "longest": 0, "mu": threading.Lock()}
    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if "NornicDB-TPU serving" not in line:
        proc.kill()
        raise AssertionError(("serve did not start", line,
                              open(c.err_path).read()[-3000:]))
    t_up = time.perf_counter() - c.t0
    t_b = time.perf_counter()
    http_port = int(line.split("http://127.0.0.1:")[1].split()[0])
    bolt_port = int(line.split("bolt://127.0.0.1:")[1].split()[0])
    grpc_port = int(line.split(" grpc://127.0.0.1:")[1].split()[0])
    qgrpc_port = int(line.split(" qdrant-grpc://127.0.0.1:")[1].split()[0])
    assert "on cuda" in line, line
    anon = _HttpClient(http_port, sheds)
    code, _, _ = anon.call("GET", "/health")
    anon.close()
    assert code == 200
    # a refused request's body is left unread on its connection (the JAX
    # server's behaviour too), so each anonymous call takes a new one
    anon = _HttpClient(http_port, sheds)
    code, body, _ = anon.call("POST", "/nornicdb/search",
                              {"query": "anything"})
    anon.close()
    assert code == 401, (code, body)
    anon = _HttpClient(http_port, sheds)
    code, tok, _ = anon.call("POST", "/auth/login",
                             {"username": "admin", "password": pw})
    anon.close()
    assert code == 200, (code, tok)
    cl = _HttpClient(http_port, sheds,
                     {"Authorization": f"Bearer {tok['token']}"})
    docs = [f"served document {i} about {EMBED_WORDS[i % len(EMBED_WORDS)]}"
            f" and {EMBED_WORDS[(7 * i) % len(EMBED_WORDS)]} w{i}x"
            for i in range(SERVE_DOCS)]
    code, body, _ = cl.call("POST", "/db/neo4j/tx/commit", {
        "statements": [{"statement": "UNWIND $rows AS r CREATE (:Doc "
                        "{content: r.c, k: r.k})",
                        "parameters": {"rows": [
                            {"c": d, "k": i} for i, d in enumerate(docs)]}}]})
    assert code == 200 and not body["errors"], body
    t1 = time.perf_counter()
    while True:
        code, stats, _ = cl.call("GET", "/admin/stats")
        if stats["pending_embeddings"] == 0:
            break
        assert time.perf_counter() - t1 < 120, stats["pending_embeddings"]
        time.sleep(0.2)
    t_embed = time.perf_counter() - t1
    code, st0, _ = cl.call("GET", "/admin/tpu/status")
    assert code == 200 and st0["backend_initialized"] is True, st0
    assert st0["devices"][0] == torch.cuda.get_device_name(0), st0
    hasher = HashEmbedder(SERVE_DIMS)
    firsts = 0
    vectors, texts = [], []
    for i in range(0, SERVE_DOCS, SERVE_DOCS // 8):
        vec = hasher.embed(docs[i]).tolist()
        code, body, _ = cl.call("POST", "/nornicdb/search", {
            "vector": vec, "limit": 5})
        assert code == 200, body
        firsts += body["results"][0]["content"] == docs[i]
        vectors.append((("vector", vec), body["results"]))
        code, body, _ = cl.call("POST", "/nornicdb/search",
                                {"query": docs[i], "limit": 5})
        assert code == 200, body
        firsts += body["results"][0]["content"] == docs[i]
        texts.append((("text", docs[i]), body["results"]))
    code, st1, _ = cl.call("GET", "/admin/tpu/status")
    d2 = (st1["kernel_launches"]["streaming_topk_bf16"]
          - st0["kernel_launches"]["streaming_topk_bf16"])
    # the native gRPC search: the same vectors and texts, answers equal
    # to HTTP's, #2 launched by them
    asked = vectors + texts
    t_grpc, lat_grpc = serve_grpc_searches(
        grpc_port, [q for q, _ in asked], [a for _, a in asked])
    code, st2, _ = cl.call("GET", "/admin/tpu/status")
    d2_grpc = (st2["kernel_launches"]["streaming_topk_bf16"]
               - st1["kernel_launches"]["streaming_topk_bf16"])
    assert d2_grpc > 0, "the gRPC searches missed #2"
    # GraphQL and Qdrant REST in the child: the documents counted, no
    # collection, and a viewer's mutation refused
    code, gq, _ = cl.call("POST", "/graphql",
                          {"query": "{ stats { nodes } }"})
    assert code == 200 and gq == {"data": {"stats": {"nodes": SERVE_DOCS}}}, (
        code, gq)
    code, colls, _ = cl.call("GET", "/collections")
    assert code == 200 and colls["result"] == {"collections": []}, colls
    code, made, _ = cl.call("POST", "/auth/users", {
        "username": "viewer", "password": "viewer-pw", "roles": ["viewer"]})
    assert code in (200, 201), (code, made)
    cl.close()
    anon = _HttpClient(http_port, sheds)
    code, vtok, _ = anon.call("POST", "/auth/login",
                              {"username": "viewer", "password": "viewer-pw"})
    anon.close()
    assert code == 200, (code, vtok)
    viewer = _HttpClient(http_port, sheds,
                         {"Authorization": f"Bearer {vtok['token']}"})
    code, vq, _ = viewer.call("POST", "/graphql",
                              {"query": "{ stats { nodes } }"})
    assert code == 200 and vq["data"]["stats"]["nodes"] == SERVE_DOCS, vq
    viewer.close()
    # a refused request's body is left unread: a new connection
    viewer = _HttpClient(http_port, sheds,
                         {"Authorization": f"Bearer {vtok['token']}"})
    vcode, refused, _ = viewer.call("POST", "/graphql", {
        "query": 'mutation { createNode(labels: ["X"]) { id } }'})
    viewer.close()
    assert vcode == 401 and refused == {
        "error": "permission write denied"}, (vcode, refused)
    # after the counts above: its points are nodes of the served DB
    qlog = serve_qdrant_grpc(http_port, qgrpc_port, tok["token"], pw, sheds)
    assert firsts == 16, ("searches answered their document first", firsts)
    assert d2 > 0, "the served searches missed #2"
    bc = _BoltClient(bolt_port, sheds)
    bad = bc.hello({"scheme": "basic", "principal": "admin",
                    "credentials": "wrong"})
    bc.close()
    assert bad.tag == 0x7F and bad.fields[0]["code"] == (
        "Neo.ClientError.Security.Unauthorized"), bad
    bc = _BoltClient(bolt_port, sheds)
    assert bc.hello({"scheme": "basic", "principal": "admin",
                     "credentials": pw}).tag == 0x70
    count = bc.run("MATCH (n:Doc) RETURN count(n)", {})
    bc.close()
    assert count == [[SERVE_DOCS]], count
    t1 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=SERVE_EXIT_S)
    t_exit = time.perf_counter() - t1
    out = proc.stdout.read()
    assert rc == 0, (rc, open(c.err_path).read()[-3000:])
    assert "shutting down" in out, out
    reopened = nornicdb_tpu_torch.open_db(c.data)
    try:
        n_docs = reopened.cypher("MATCH (n:Doc) RETURN count(n)").rows
    finally:
        reopened.close()
    assert n_docs == [[SERVE_DOCS]], n_docs
    r_out, r_err = c.refused.communicate(timeout=300)
    assert c.refused.returncode != 0, r_out
    assert "ROADMAP A6d" in r_err, r_err[-2000:]
    assert not os.path.exists(c.data + "-refused")
    log(f"[phase17] (b) serve --auth --embedder hash on the card: "
        f"serving {t_up:.2f}s after its start (after 17(a)); "
        f"unauthenticated search 401; {SERVE_DOCS} documents stored and "
        f"embedded in {t_embed:.2f}s; 16 searches answered their document "
        f"first, #2 launched {d2} times in the child (its "
        f"/admin/tpu/status: {st1['devices']}, "
        f"{json.dumps(st1['kernel_launches'])}); native gRPC from "
        f"{SERVE_CLIENTS} clients: {len(asked)} searches ({len(vectors)} "
        f"raw-vector, {len(texts)} text) in {t_grpc:.2f}s, "
        f"{_pcts(lat_grpc)}, each equal to the HTTP answer (ids, content, "
        f"scores at float32), #2 launched {d2_grpc} times by them; "
        f"{qlog}; /graphql stats "
        f"{gq['data']['stats']}, /collections {colls['result']}, a viewer's "
        f"mutation {vcode} {refused['error']!r}; Bolt wrong password "
        f"Unauthorized, right one SUCCESS; SIGTERM -> exit {rc} in "
        f"{t_exit:.2f}s, a reopen finds {n_docs[0][0]} documents; "
        f"--workers 2 -> exit {c.refused.returncode} "
        f"({r_err.strip().splitlines()[-1]}); checks "
        f"{time.perf_counter() - t_b:.2f}s; both children exited by "
        f"time.time() {time.time():.1f}")


# The messages of the ResourceExhausted that the serving engine and the
# search batcher raise when they shed (serving/engine.py,
# search/batcher.py): what a shed becomes inside GraphQL, a field error
# with the exception's text, as in the JAX package.
SHED_MESSAGE = re.compile(
    r"(search batch|embed) queue full \(.*\); retry with backoff"
    r"|predicted (search )?completion \d+ms exceeds the \d+ms deadline "
    r"budget; retry with backoff"
    r"|(search|embed) deadline exceeded( before dispatch)?")


def _gql(cl, sheds: dict, query: str, variables=None,
         retry: bool = True) -> tuple:
    """POST /graphql: (data, seconds). With ``retry`` (reads only), an
    answer whose every field error is a shed (SHED_MESSAGE) is asked again
    after a second, at most BACKOFF_TRIES times, counted in
    ``sheds["fields"]`` with its messages (digits as N) in
    ``sheds["messages"]``. Any other field error fails at once; the answer
    must come without errors."""
    t0 = time.perf_counter()
    for run in range(1, (BACKOFF_TRIES if retry else 1) + 1):
        code, body, _ = cl.call("POST", "/graphql", {
            "query": query, "variables": variables or {}})
        assert code == 200, (code, body)
        errs = [e.get("message", "") for e in body.get("errors", ())]
        if not errs or not retry or run == BACKOFF_TRIES or not all(
                SHED_MESSAGE.fullmatch(m) for m in errs):
            break
        with sheds["mu"]:
            sheds["fields"] += 1
            for m in errs:
                m = re.sub(r"\d+", "N", m)
                sheds["messages"][m] = sheds["messages"].get(m, 0) + 1
        time.sleep(1.0)
    assert "errors" not in body, (query, body)
    return body["data"], time.perf_counter() - t0


def _decode_step(corpus) -> float:
    """#2's score decode step at this corpus's capacity (as phase 17(a))."""
    from nornicdb_tpu_torch.ops.kernels import pick_tile_n, streaming_geometry

    cap = corpus.capacity
    return 2.0 ** (streaming_geometry(cap, pick_tile_n(cap), 1)[2] - 22)


def phase_graphql(K, db, served: dict, seed: int) -> None:
    """Phase 18(a): GraphQL over phase 10's DB behind a port ``HttpServer``
    (wired as ``cmd_serve`` wires it). SERVE_CLIENTS clients send
    GQL_SEARCHES ``search`` and GQL_SIMILAR ``similar`` fields and one of
    each other read (``stats``, ``node``, ``nodes``, ``neighbors``, a
    ``cypher`` ``queryNodes`` call, introspection, a document with a
    fragment, an alias, variables and ``@include`` / ``@skip``). With no
    writer active, each answer is held to the DB: ``search`` to
    ``db.search.search`` (rank cache cleared) in ids, scores and content;
    ``similar`` to ``vector_candidates(node.embedding, k + 1)`` without the
    node (ids; scores within #2's decode step); the rest to the storage,
    ``db.neighbors`` and ``db.cypher`` (query cache cleared). #2 launches.
    No mutation: phase 14 reopens this DB's snapshot."""
    from nornicdb_tpu_torch.server import HttpServer
    from nornicdb_tpu_torch.server.http import _jsonable

    rng = np.random.default_rng(seed + 18)
    texts, embs = served["texts"], served["embs"]
    svc = db.search
    http = HttpServer(db, host="127.0.0.1", port=0)
    http.start()
    queries: list = []
    for r in rng.permutation(len(texts)):
        q = " ".join(texts[r].split()[-3:])  # the last word is unique
        if q not in queries:
            queries.append(q)
        if len(queries) == GQL_SEARCHES:
            break
    sim_ids = [f"t{r}" for r in rng.choice(len(texts), GQL_SIMILAR,
                                           replace=False)]
    one = sim_ids[0]
    q_nodes = ("CALL db.index.vector.queryNodes('default', $k, $v) "
               "YIELD node, score RETURN node.id, score")
    q_vec = (embs[int(one[1:])] + 0.01 * rng.standard_normal(
        embs.shape[1])).astype(np.float32)
    docs = {
        "search": ("query S($q: String, $n: Int = 10) { search(query: $q, "
                   "limit: $n) { id score content node { id labels } } }"),
        "similar": ("query M($id: ID, $n: Int) { similar(id: $id, limit: "
                    "$n) { id score } }"),
        "stats": "{ stats { nodes edges pendingEmbeddings } }",
        "node": ("query N($id: ID) { node(id: $id) { id labels properties "
                 "decayScore accessCount } }"),
        "nodes": '{ nodes(label: "Doc", limit: 16) { id } }',
        "neighbors": "query B($id: ID) { neighbors(id: $id) { id } }",
        "cypher": ("query C($s: String, $p: JSON) { cypher(statement: $s, "
                   "parameters: $p) { columns rows } }"),
        "introspection": ('{ __schema { queryType { name } mutationType '
                          '{ name } types { name kind } } __type(name: '
                          '"Node") { name fields { name } } }'),
        "fragment": ("query F($id: ID, $yes: Boolean = true, $no: Boolean = "
                     "false) { doc: node(id: $id) { ...Bits labels "
                     "@include(if: $no) properties @skip(if: $yes) } "
                     "counts: stats @include(if: $yes) { nodes } } "
                     "fragment Bits on Node { id __typename }"),
    }
    work = ([("search", i, {"q": queries[i]}) for i in range(GQL_SEARCHES)]
            + [("similar", i, {"id": sim_ids[i], "n": SERVE_K})
               for i in range(GQL_SIMILAR)]
            + [("stats", 0, None), ("node", 0, {"id": one}),
               ("nodes", 0, None), ("neighbors", 0, {"id": one}),
               ("cypher", 0, {"s": q_nodes, "p": {"k": SERVE_K,
                                                  "v": q_vec.tolist()}}),
               ("introspection", 0, None), ("fragment", 0, {"id": one})])
    work = [work[j] for j in rng.permutation(len(work))]
    got: dict = {}
    lat: dict = {"search": [], "similar": [], "other": []}
    sheds = {"n": 0, "longest": 0, "fields": 0, "messages": {},
             "mu": threading.Lock()}

    def client(c: int, items: list) -> None:
        cl = _HttpClient(http.port, sheds)
        try:
            for kind, i, variables in items:
                got[(kind, i)], dt = _gql(cl, sheds, docs[kind], variables)
                with sheds["mu"]:
                    lat[kind if kind in lat else "other"].append(dt)
        finally:
            cl.close()

    try:
        c0 = K.launch_counts()
        t0 = time.perf_counter()
        in_threads(lambda c: client(c, work[c::SERVE_CLIENTS]),
                   list(range(SERVE_CLIENTS)), SERVE_CLIENTS)
        wall = time.perf_counter() - t0
        launches = _launch_delta(K, c0)
        log(f"[phase18] (a) {len(work)} GraphQL documents from "
            f"{SERVE_CLIENTS} clients over {db.storage.node_count()} nodes "
            f"in {wall:.2f}s: "
            + "; ".join(f"{k} {_pcts(v)} ({len(v)})" for k, v in lat.items())
            + f"; 429s retried {sheds['n']}, answers with only shed field "
            f"errors retried {sheds['fields']} "
            f"({json.dumps(sheds['messages'])}); launches "
            f"{json.dumps(launches)}")
        # -- the answers, held to the DB with no writer active
        t0 = time.perf_counter()
        tol = _decode_step(svc.corpus())
        diff = 0.0
        with svc._lock:
            svc._rank_cache.clear()
        for i, q in enumerate(queries):
            want = _Backoff()(svc.search, q, limit=SERVE_K)
            body = got[("search", i)]["search"]
            assert body, ("no search results", q)
            assert [(r["id"], r["score"], r["content"], r["node"]["id"])
                    for r in body] == [
                (w["id"], w["score"], w["content"], w["id"])
                for w in want], ("search", i, q)
        for i, nid in enumerate(sim_ids):
            node = db.storage.get_node(nid)
            fresh = [(a, b) for a, b in svc.vector_candidates(
                node.embedding, k=SERVE_K + 1) if a != nid][:SERVE_K]
            body = got[("similar", i)]["similar"]
            assert [r["id"] for r in body] == [a for a, _ in fresh], (
                "similar", nid)
            diff = max(diff, max(abs(r["score"] - b)
                                 for r, (_, b) in zip(body, fresh)))
        db.query_cache.clear()
        want = db.cypher(q_nodes, {"k": SERVE_K, "v": q_vec.tolist()})
        body = got[("cypher", 0)]["cypher"]
        assert body["columns"] == want.columns, body["columns"]
        assert [r[0] for r in body["rows"]] == [w[0] for w in want.rows]
        diff = max(diff, max(abs(r[1] - w[1])
                             for r, w in zip(body["rows"], want.rows)))
        assert diff <= tol, ("scores", diff, tol)
        assert got[("stats", 0)]["stats"] == {
            "nodes": db.storage.node_count(),
            "edges": db.storage.edge_count(),
            "pendingEmbeddings": len(db.storage.pending_embed_ids())}
        n = db.storage.get_node(one)
        assert got[("node", 0)]["node"] == {
            "id": n.id, "labels": list(n.labels),
            "properties": _jsonable(dict(n.properties)),
            "decayScore": n.decay_score, "accessCount": n.access_count}
        by_label = sorted(db.storage.get_nodes_by_label("Doc"),
                          key=lambda x: x.id)[:16]
        assert [r["id"] for r in got[("nodes", 0)]["nodes"]] == [
            x.id for x in by_label]
        assert [r["id"] for r in got[("neighbors", 0)]["neighbors"]] == [
            x.id for x in db.neighbors(one)]
        intro = got[("introspection", 0)]
        assert intro["__schema"]["queryType"]["name"] == "Query"
        assert {"Query", "Mutation", "Node", "Relationship"} <= {
            t["name"] for t in intro["__schema"]["types"]}
        assert {"id", "labels", "properties"} <= {
            f["name"] for f in intro["__type"]["fields"]}
        assert got[("fragment", 0)] == {
            "doc": {"id": one, "__typename": "Node"},
            "counts": {"nodes": db.storage.node_count()}}
        assert launches["streaming_topk_bf16"] > 0, "GraphQL missed #2"
        log(f"[phase18] (a) checks {time.perf_counter() - t0:.2f}s: "
            f"{GQL_SEARCHES} search fields equal to db.search.search in "
            f"ids, scores and content; {GQL_SIMILAR} similar fields and the "
            f"cypher queryNodes rows equal to vector_candidates / db.cypher "
            f"in ids, max |score - reference| {diff:.6g} (bound: #2's "
            f"decode step {tol:.6g}); stats, node, nodes, neighbors, "
            f"introspection and the fragment document equal to the DB; #2 "
            f"launched {launches['streaming_topk_bf16']} times")
    finally:
        http.stop()


def qdrant_loader(port: int, path: str, first: int, step: int,
                  transport: str = "rest") -> None:
    """Phase 18(b)'s loader process: upserts the points of batches
    ``first``, ``first + step``, ... of QDRANT_BATCH points of ``path.npy``
    (the embeddings) with their payloads (``path.json``: the words). Over
    REST through ``PUT /collections/docs/points`` on one keep-alive
    connection, the vectors written as ``%.9g`` (which float32 round-trips
    exactly); over gRPC (``transport="grpc"``) as Qdrant ``Upserts`` of
    QDRANT_GRPC_BATCH points on one ``grpcwire.Channel``, the vectors as
    their float32 bytes. Prints one JSON line: the request and encode
    times, the points and the wall clock at its first and last request."""
    if transport == "grpc":
        return qdrant_grpc_loader(port, path, first, step)
    import http.client
    import io

    embs = np.load(path + ".npy", mmap_mode="r")
    with open(path + ".json") as f:
        words = json.load(f)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    sent, encode, loaded = [], [], 0
    t_first = time.time()
    for lo in range(first * QDRANT_BATCH, len(words), step * QDRANT_BATCH):
        t0 = time.perf_counter()
        hi = min(lo + QDRANT_BATCH, len(words))
        buf = io.StringIO()
        np.savetxt(buf, embs[lo:hi], fmt="%.9g", delimiter=",")
        points = ",".join(
            '{"id":%d,"vector":[%s],"payload":{"doc":%d,"group":%d,'
            '"word":%s}}' % (i, row, i, i % QDRANT_GROUPS,
                             json.dumps(words[i]))
            for i, row in zip(range(lo, hi), buf.getvalue().splitlines()))
        body = ('{"points":[' + points + "]}").encode()
        t1 = time.perf_counter()
        conn.request("PUT", "/collections/docs/points", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        assert resp.status == 200, (resp.status, raw[:500])
        assert json.loads(raw)["result"]["upserted"] == hi - lo, raw[:500]
        sent.append(time.perf_counter() - t1)
        encode.append(t1 - t0)
        loaded += hi - lo
    conn.close()
    print(json.dumps({"sent": sent, "encode": encode, "transport": "rest",
                      "points": loaded, "t_first": t_first,
                      "t_last": time.time()}), flush=True)


def qdrant_grpc_loader(port: int, path: str, first: int, step: int) -> None:
    """``qdrant_loader`` over the Qdrant gRPC service: each batch of
    QDRANT_BATCH points in Upserts of QDRANT_GRPC_BATCH."""
    from nornicdb_tpu_torch.server import grpcwire
    from nornicdb_tpu_torch.server import qdrant_grpc as Q

    embs = np.load(path + ".npy", mmap_mode="r")
    with open(path + ".json") as f:
        words = json.load(f)
    sent, encode, points = [], [], 0
    t_first = time.time()
    with grpcwire.Channel("127.0.0.1", port) as ch:
        upsert = ch.unary_unary("/qdrant.Points/Upsert")
        for lo0 in range(first * QDRANT_BATCH, len(words),
                         step * QDRANT_BATCH):
            for lo in range(lo0, min(lo0 + QDRANT_BATCH, len(words)),
                            QDRANT_GRPC_BATCH):
                t0 = time.perf_counter()
                hi = min(lo + QDRANT_GRPC_BATCH, lo0 + QDRANT_BATCH,
                         len(words))
                req = qdrant_upsert_request(
                    "docs", range(lo, hi), embs[lo:hi],
                    [{"doc": i, "group": i % QDRANT_GROUPS, "word": words[i]}
                     for i in range(lo, hi)])
                t1 = time.perf_counter()
                out = Q._parse(upsert(req, timeout=600))
                assert Q._parse(out[1][0][1])[2][0][1] == 2, out  # Completed
                sent.append(time.perf_counter() - t1)
                encode.append(t1 - t0)
                points += hi - lo
    print(json.dumps({"sent": sent, "encode": encode, "transport": "grpc",
                      "points": points, "t_first": t_first,
                      "t_last": time.time()}), flush=True)


def _same_hits(got: list, want: list, tol: float, what) -> None:
    """Equal hit lists, scores within ``tol``; two hits whose scores lie
    within ``tol`` may trade places (or, at the limit, one may be cut for
    the other)."""
    assert len(got) == len(want), (what, len(got), len(want))
    in_g = {h[0]: h[1] for h in got}
    in_w = {h[0]: h[1] for h in want}
    for (gi, gs), (wi, ws) in zip(got, want):
        assert abs(gs - ws) <= tol, (what, gi, gs, wi, ws)
        if gi == wi:
            continue
        for i, s, other, seq in ((gi, gs, in_w, want), (wi, ws, in_g, got)):
            twin = other.get(i)
            assert abs((seq[-1][1] if twin is None else twin) - s) <= tol, (
                what, i, s, twin)


class QdrantChild:
    """Phase 18(b)'s process on the card (``qdrant_child``), started after
    18(a) so that it runs beside phase 10's close and phases 11 and 14
    on a core of its own, and collected after phase 14 (``collect``): the
    port's Qdrant REST server is host code under one interpreter lock (a
    filtered search scans every point), which the parent's phases would
    otherwise wait behind. Its points (phase 8's first QDRANT_POINTS
    embeddings, the texts' last words) go to files under .chip_scratch,
    which its loader processes read too."""

    def __init__(self, seed: int):
        self.here = os.path.dirname(os.path.abspath(__file__))
        self.work = os.path.join(self.here, ".chip_scratch", "qdrant18")
        self.base = os.path.join(self.work, "points")
        self.out = os.path.join(self.work, "child.out")
        self.seed = seed
        self.proc = None

    def start(self, served: dict) -> "QdrantChild":
        import shutil

        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        embs, texts = served["embs"], served["texts"]
        assert len(embs) >= QDRANT_POINTS, (len(embs), QDRANT_POINTS)
        np.save(self.base + ".npy",
                np.ascontiguousarray(embs[:QDRANT_POINTS], np.float32))
        with open(self.base + ".json", "w") as f:
            json.dump([t.split()[-1] for t in texts[:QDRANT_POINTS]], f)
        self.t0 = time.perf_counter()
        call = (f"import chip_smoke as C; C.qdrant_child({self.base!r}, "
                f"{self.seed})")
        with open(self.out, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", call], cwd=self.here, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)
        return self

    def collect(self, timeout: float = 900.0) -> dict:
        """Wait for the child; it must exit 0 with its result as the last
        line. Its log lines are logged here; returns the result."""
        self.proc.wait(timeout=timeout)
        seconds = time.perf_counter() - self.t0
        with open(self.out) as f:
            lines = f.read().split("\n")[:-1]
        assert self.proc.returncode == 0, (self.proc.returncode,
                                           "\n".join(lines[-60:]))
        for line in lines[:-1]:
            if line.startswith("[phase18]"):
                log(line)
        result = json.loads(lines[-1])
        assert result["launches"]["streaming_topk_bf16"] > 0, result
        log(f"[phase18] (b) the child exited 0 {seconds:.1f}s after its "
            f"start; #2 launched {result['launches']['streaming_topk_bf16']}"
            f" times in it ({result['launches_search']} in its unfiltered "
            f"searches); load points/s {json.dumps(result['load_rates'])}")
        return result

    def state(self) -> str:
        """For the log lines of the phases it may run beside: their
        readings are not taken alone while it runs."""
        running = self.proc is not None and self.proc.poll() is None
        return "18(b)'s child " + ("running" if running else "not running")

    def close(self) -> None:
        import shutil

        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def qdrant_child(base: str, seed: int) -> None:
    """Phase 18(b) in a process of its own on the card: the device owner,
    then ``phase_qdrant`` over the points under ``base``; its last line is
    the result (#2's launches in the phase and in its unfiltered
    searches, each transport's load rate). Then it stops the owner and
    leaves with ``os._exit``: the owner's daemon threads may be inside a
    CUDA call while the interpreter tears down, which once aborted such a
    child after its result ("terminate called without an active
    exception")."""
    from nornicdb_tpu_torch.ops import kernels as K

    start_device_owner()
    vecs = np.load(base + ".npy")
    with open(base + ".json") as f:
        words = json.load(f)
    c0 = K.launch_counts()
    searched, rates = phase_qdrant(K, base, vecs, words, seed)
    print(json.dumps({"launches": _launch_delta(K, c0),
                      "launches_search": searched, "load_rates": rates}),
          flush=True)
    OWNER["manager"].stop()
    sys.stderr.flush()
    os._exit(0)


def decay_reference(types, counts, accessed, importance,
                    now: float) -> np.ndarray:
    """This script's own float64 copy of the decay score of
    ``nornicdb_tpu/decay/decay.py`` (``HALF_LIVES`` and
    ``calculate_score``: recency halves every 7 / 69 / 693 days by memory
    type, frequency is log1p(accesses) / log(11) capped at 1, importance
    clamped to [0, 1]; 0.4, 0.3 and 0.3 of them, clamped to [0, 1])."""
    day = 86400.0
    hl = np.array([{"episodic": 7.0, "semantic": 69.0,
                    "procedural": 693.0}[t] for t in types]) * day
    age = np.maximum(now - np.asarray(accessed, np.float64), 0.0)
    recency = np.exp(-np.log(2.0) * age / hl)
    freq = np.minimum(np.log1p(np.asarray(counts, np.float64))
                      / np.log(11.0), 1.0)
    imp = np.clip(np.asarray(importance, np.float64), 0.0, 1.0)
    return np.clip(0.4 * recency + 0.3 * freq + 0.3 * imp, 0.0, 1.0)


def decay_vectors(seed: int, n: int = DECAY_NODES, d: int = DIMS
                  ) -> np.ndarray:
    """Phase 19's memories: ``n`` seeded unit vectors of width ``d``."""
    v = np.random.default_rng(seed + 191).standard_normal((n, d),
                                                         dtype=np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def phase_decay(K, vecs: np.ndarray, seed: int, device: str = "cuda") -> dict:
    """Phase 19: memory decay at full size on the card. An in-memory
    ``DB(Config(decay_enabled=True))`` opens with its ticker running; its
    storage takes ``len(vecs)`` memories (``decay_vectors``: as many as
    #2's threshold, so a search over them runs #2) with seeded memory types, access counts,
    last accesses up to 30 days old and importances; DECAY_QUERIES
    searches through ``db.search.vector_candidates``; the manager's clock
    moved DECAY_AHEAD_DAYS ahead, ``recalculate_all()``: every score
    within DECAY_TOL of ``decay_reference`` and the archived count the
    one that copy predicts (no reference score within DECAY_TOL of the
    threshold); the same searches give the same ids and scores after
    decay's ``update_node`` storm; ``CALL nornicdb.decay.info()`` gives
    the enabled row; ``close()`` stops the ticker. Returns its numbers."""
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.db import Config
    from nornicdb_tpu_torch.storage import Node

    rng = np.random.default_rng(seed + 190)
    n = len(vecs)
    types = rng.choice(["episodic", "semantic", "procedural"], n)
    counts = np.where(rng.random(n) < 0.3, 0, rng.geometric(0.2, n))
    importance = np.round(rng.random(n), 6)
    t0 = time.perf_counter()
    db = nornicdb_tpu_torch.open_db("", Config(decay_enabled=True),
                                    device=device)
    try:
        mgr = db.decay
        assert mgr._timer is not None and mgr._timer.is_alive(), (
            "the decay ticker is not running")
        now0 = time.time()
        accessed = now0 - rng.uniform(0.0, 30.0, n) * 86400.0
        for i in range(n):
            node = Node(id=f"mem{i}", labels=["Memory"],
                        memory_type=str(types[i]), embedding=vecs[i],
                        properties={"content": f"memory {i}",
                                    "importance": float(importance[i])})
            node.access_count = int(counts[i])
            node.last_accessed = float(accessed[i])
            db.storage.create_node(node)
        svc = db.search  # built and backfilled on first use
        svc.vector_candidates(vecs[0], k=1)  # the first upload
        t_fill = time.perf_counter() - t0
        rows = rng.choice(n, DECAY_QUERIES, replace=False)
        qs = (vecs[rows] + 0.01 * rng.standard_normal(
            (DECAY_QUERIES, vecs.shape[1]))).astype(np.float32)
        c0 = K.launch_counts()
        before = [svc.vector_candidates(q, k=SERVE_K) for q in qs]
        launches = _launch_delta(K, c0)
        assert launches["streaming_topk_bf16"] > 0, "decay's searches missed #2"
        assert all(before[j][0][0] == f"mem{rows[j]}"
                   for j in range(DECAY_QUERIES)), "a query missed its own node"
        now = now0 + DECAY_AHEAD_DAYS * 86400.0
        mgr.now = lambda: now
        t1 = time.perf_counter()
        scored, archived = mgr.recalculate_all()
        t_decay = time.perf_counter() - t1
        ref = decay_reference(types, counts, accessed, importance, now)
        thr = mgr.config.archive_threshold
        assert float(np.abs(ref - thr).min()) > DECAY_TOL, "a tie at the bound"
        got = np.array([db.storage.get_node(f"mem{i}").decay_score
                        for i in range(n)])
        err = float(np.abs(got - ref).max())
        predicted = int((ref < thr).sum())
        worst = [(f"mem{i}", float(got[i]), float(ref[i]),
                  vars(db.storage.get_node(f"mem{i}")) | {"embedding": None},
                  str(types[i]), int(counts[i]), float(accessed[i]),
                  float(importance[i]))
                 for i in np.argsort(-np.abs(got - ref))[:3]]
        assert scored == n and err <= DECAY_TOL, (scored, err, now, worst)
        assert archived == predicted == len(mgr.archived_nodes()), (
            archived, predicted)
        c0 = K.launch_counts()
        after = [svc.vector_candidates(q, k=SERVE_K) for q in qs]
        launches_after = _launch_delta(K, c0)
        assert after == before, "decay's updates disturbed the corpus"
        assert launches_after["streaming_topk_bf16"] > 0
        info = db.cypher("CALL nornicdb.decay.info()").rows
        assert info and info[0][0] is True, info
    finally:
        db.close()
    mgr._timer.join(timeout=5)
    assert mgr._stopped and not mgr._timer.is_alive(), "the ticker runs on"
    log(f"[phase19] decay: DB(Config(decay_enabled=True)) of {n} memories x "
        f"{vecs.shape[1]} on {db.device} (ticker running, interval "
        f"{mgr.config.interval:.0f}s), filled and indexed in {t_fill:.1f}s; "
        f"the clock {DECAY_AHEAD_DAYS:.0f} days ahead: recalculate_all() "
        f"{t_decay:.2f}s, {scored} scored, every score within {err:.3g} of "
        f"the float64 reference (bound {DECAY_TOL:g}), {archived} archived "
        f"below {thr} ({predicted} predicted); {DECAY_QUERIES} searches "
        f"before and after equal in ids and scores, #2 launched "
        f"{launches['streaming_topk_bf16']} and "
        f"{launches_after['streaming_topk_bf16']} times; "
        f"nornicdb.decay.info() {info[0]}; close() stopped the ticker")
    return {"nodes": n, "scored": scored, "archived": archived,
            "max_err": err, "recalculate_s": t_decay, "fill_s": t_fill,
            "launches": launches["streaming_topk_bf16"]
            + launches_after["streaming_topk_bf16"]}


def phase_qdrant(K, base: str, vecs: np.ndarray, words: list, seed: int,
                 device: str = "cuda") -> tuple:
    """Phase 18(b): the Qdrant REST API over a fresh in-memory port DB on
    the card (``open_db("")``, its own ``HttpServer``). A named-vector
    collection of QDRANT_NAMED points (``dense``, 1,024 wide, and
    ``small``, QDRANT_SMALL wide): each name searched, its snapshot equal
    to what was upserted. A collection of the QDRANT_POINTS 1,024-wide
    Cosine points under ``base`` (payload doc, group, the text's last
    word) loaded in batches of QDRANT_BATCH by QDRANT_LOADERS client
    processes, QDRANT_GRPC_LOADERS of them through the Qdrant gRPC service
    (a ``QdrantGrpcServer`` over the same registry), the others through
    REST; QDRANT_SEARCHES unfiltered searches from SERVE_CLIENTS
    clients through #2, the odd-numbered over gRPC (ids equal to the
    registry's own answer, scores within #2's decode step of it and within
    one bf16 step of the exact float32 cosine, recall@SERVE_K against that
    exact scan >= 0.95; a gRPC answer equal to REST's for the same request
    in ids, order and float32 scores); QDRANT_FILTERED group-filtered
    searches, the odd-numbered over gRPC (the exact filtered answer, ties
    within a bf16 step aside, and REST's); count, scroll through one
    group (a gRPC Count and Scroll page equal to REST's), retrieve,
    delete, the collection GETs; GraphQL's five mutations held to the
    storage. Returns #2's launches in the unfiltered searches."""
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.server import HttpServer, grpcwire
    from nornicdb_tpu_torch.server import qdrant_grpc as Q
    from nornicdb_tpu_torch.server.qdrant_grpc import QdrantGrpcServer

    rng = np.random.default_rng(seed + 180)
    n = len(vecs)
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    groups = np.arange(n) % QDRANT_GROUPS
    here = os.path.dirname(os.path.abspath(__file__))
    db = nornicdb_tpu_torch.open_db("", device=device)
    http = HttpServer(db, host="127.0.0.1", port=0)
    http.start()
    sheds = {"n": 0, "longest": 0, "mu": threading.Lock()}
    cl = _HttpClient(http.port, sheds)
    procs: list = []
    qsrv = None
    try:
        registry = db.qdrant_registry()
        # the Qdrant gRPC services over the registry the REST routes use
        qsrv = QdrantGrpcServer(registry, host="127.0.0.1", port=0)
        qsrv.start()
        # -- a named-vector collection, before the large one, so that its
        # snapshot's scan of the points is a scan of its own
        t0 = time.perf_counter()
        small = rng.standard_normal((QDRANT_NAMED, QDRANT_SMALL)).astype(
            np.float32)
        code, out, _ = cl.call("PUT", "/collections/multi", {"vectors": {
            "dense": {"size": vecs.shape[1], "distance": "Cosine"},
            "small": {"size": QDRANT_SMALL, "distance": "Cosine"}}})
        assert code == 200, out
        points = [{"id": f"m{i}", "vector": {"dense": vecs[i].tolist(),
                                             "small": small[i].tolist()},
                   "payload": {"i": i}} for i in range(QDRANT_NAMED)]
        code, out, _ = cl.call("PUT", "/collections/multi/points",
                               {"points": points})
        assert code == 200 and out["result"]["upserted"] == QDRANT_NAMED
        for name, table in (("dense", vecs), ("small", small)):
            for i in (3, QDRANT_NAMED - 5):
                code, out, _ = cl.call(
                    "POST", "/collections/multi/points/search",
                    {"vector": {"name": name, "vector": table[i].tolist()},
                     "limit": 3})
                assert code == 200 and out["result"][0]["id"] == f"m{i}", (
                    name, i, out)
                assert out["result"][0]["payload"] == {"i": i}
        for key in ("multi/dense", "multi/small"):
            assert registry._corpora[key].device == db.device, key
        code, out, dt_snap = cl.call("POST", "/collections/multi/snapshots",
                                     {})
        assert code == 200 and out["result"]["count"] == QDRANT_NAMED
        snap = sorted(out["result"]["points"], key=lambda p: p["payload"]["i"])
        for i, p in enumerate(snap):
            assert p["id"] == f"m{i}" and p["payload"] == {"i": i}
            assert np.array_equal(np.asarray(p["vector"]["dense"],
                                             np.float32), vecs[i])
            assert np.array_equal(np.asarray(p["vector"]["small"],
                                             np.float32), small[i])
        log(f"[phase18] (b) named vectors: {QDRANT_NAMED} points (dense "
            f"{vecs.shape[1]}, small {QDRANT_SMALL}) on {db.device}, each "
            f"name searched, the snapshot ({dt_snap:.2f}s) equal to what "
            f"was upserted; {time.perf_counter() - t0:.2f}s")
        code, out, _ = cl.call("PUT", "/collections/docs", {
            "vectors": {"size": vecs.shape[1], "distance": "Cosine"}})
        assert code == 200 and out["result"] is True, (code, out)
        # -- the load, from QDRANT_LOADERS processes
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        for c in range(QDRANT_LOADERS):
            grpc = c >= QDRANT_LOADERS - QDRANT_GRPC_LOADERS
            call = (f"import chip_smoke as C; C.qdrant_loader("
                    f"{qsrv.port if grpc else http.port}, {base!r}, {c}, "
                    f"{QDRANT_LOADERS}, {'grpc' if grpc else 'rest'!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", call], cwd=here, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        reports = []
        for p in procs:
            o, e = p.communicate(timeout=600)
            assert p.returncode == 0, (p.returncode, e[-3000:])
            reports.append(json.loads(o.strip().splitlines()[-1]))
        t_load = time.perf_counter() - t0
        corpus = registry._corpora["docs"]
        assert corpus.device == db.device, (corpus.device, db.device)
        assert len(corpus) == n, len(corpus)
        by: dict = {}
        for r in reports:  # each transport's points over its own span
            b = by.setdefault(r["transport"], {
                "points": 0, "sent": [], "encode": [], "t0": r["t_first"],
                "t1": r["t_last"]})
            b["points"] += r["points"]
            b["sent"] += r["sent"]
            b["encode"] += r["encode"]
            b["t0"], b["t1"] = (min(b["t0"], r["t_first"]),
                                max(b["t1"], r["t_last"]))
        assert by["rest"]["points"] == by["grpc"]["points"] == n // 2, {
            k: v["points"] for k, v in by.items()}
        rates = {k: v["points"] / (v["t1"] - v["t0"]) for k, v in by.items()}
        log(f"[phase18] (b) load: {n} points x {vecs.shape[1]} from "
            f"{QDRANT_LOADERS} processes in {t_load:.2f}s "
            f"({n / t_load:.1f} points/s); "
            + "; ".join(
                f"{k} {v['points']} points in {len(v['sent'])} requests of "
                f"{QDRANT_BATCH if k == 'rest' else QDRANT_GRPC_BATCH} at "
                f"{rates[k]:.1f} points/s, a request's p50 "
                f"{np.median(v['sent']) * 1e3:.1f}ms p99 "
                f"{np.percentile(v['sent'], 99) * 1e3:.1f}ms, its encode in "
                f"the client p50 {np.median(v['encode']) * 1e3:.1f}ms"
                for k, v in sorted(by.items()))
            + " (REST alone: 1,073.4 points/s, copied from PERF.md, not "
            f"measured here); corpus on {corpus.device}, capacity "
            f"{corpus.capacity}")
        code, out, _ = cl.call("POST", "/collections/docs/points/count", {})
        assert code == 200 and out["result"]["count"] == n, out
        # -- unfiltered searches through #2, from SERVE_CLIENTS clients
        q_rows = rng.choice(n, QDRANT_SEARCHES, replace=False)
        qs = (vecs[q_rows] + 0.01 * rng.standard_normal(
            (len(q_rows), vecs.shape[1]))).astype(np.float32)
        f_rows = rng.choice(n, QDRANT_FILTERED, replace=False)
        fq = (vecs[f_rows] + 0.01 * rng.standard_normal(
            (len(f_rows), vecs.shape[1]))).astype(np.float32)
        got: dict = {}
        lat: dict = {f"{k} {t}": [] for k in ("search", "filtered")
                     for t in ("rest", "grpc")}

        def rest_body(kind: str, i: int) -> dict:
            body = {"vector": (qs if kind == "search" else fq)[i].tolist(),
                    "limit": SERVE_K}
            if kind == "filtered":
                body["filter"] = {"must": [{"key": "group", "match": {
                    "value": int(i % QDRANT_GROUPS)}}]}
            return body

        def client(c: int, items: list) -> None:
            # the odd-numbered searches over gRPC, the others over REST
            hc = _HttpClient(http.port, sheds)
            ch = grpcwire.Channel("127.0.0.1", qsrv.port)
            try:
                for kind, i in items:
                    t = time.perf_counter()
                    if i % 2:
                        got[(kind, i)] = qdrant_hits(ch.unary_unary(
                            "/qdrant.Points/Search")(qdrant_search_request(
                                "docs", (qs if kind == "search" else fq)[i],
                                SERVE_K, None if kind == "search" else
                                i % QDRANT_GROUPS), timeout=600))
                        dt = time.perf_counter() - t
                    else:
                        code, out, dt = hc.call(
                            "POST", "/collections/docs/points/search",
                            rest_body(kind, i))
                        assert code == 200, (kind, i, code, out)
                        got[(kind, i)] = out["result"]
                    with sheds["mu"]:
                        lat[kind + (" grpc" if i % 2 else " rest")].append(dt)
            finally:
                ch.close()
                hc.close()

        work_s = [("search", i) for i in range(QDRANT_SEARCHES)]
        c0 = K.launch_counts()
        t0 = time.perf_counter()
        in_threads(lambda c: client(c, work_s[c::SERVE_CLIENTS]),
                   list(range(SERVE_CLIENTS)), SERVE_CLIENTS)
        wall_s = time.perf_counter() - t0
        launches_s = _launch_delta(K, c0)
        # the filtered searches one after another: each scans every point
        # under one interpreter lock, so more clients only queue
        work_f = [("filtered", i) for i in range(QDRANT_FILTERED)]
        c0 = K.launch_counts()
        t0 = time.perf_counter()
        client(0, work_f)
        wall_f = time.perf_counter() - t0
        launches_f = _launch_delta(K, c0)
        log(f"[phase18] (b) {QDRANT_SEARCHES} unfiltered searches from "
            f"{SERVE_CLIENTS} clients in {wall_s:.2f}s "
            f"({QDRANT_SEARCHES / wall_s:.1f}/s), REST "
            f"{_pcts(lat['search rest'])}, gRPC {_pcts(lat['search grpc'])}, "
            f"launches {json.dumps(launches_s)}; {QDRANT_FILTERED} "
            f"group-filtered from 1 client in {wall_f:.2f}s, REST "
            f"{_pcts(lat['filtered rest'])}, gRPC "
            f"{_pcts(lat['filtered grpc'])}, "
            f"launches {json.dumps(launches_f)}")
        # each gRPC answer against REST's for the same request: same ids
        # in the same order, scores equal at the wire's float32
        t0 = time.perf_counter()
        for kind, m in (("search", QDRANT_SEARCHES),
                        ("filtered", QDRANT_FILTERED)):
            for i in range(1, m, 2):
                code, out, _ = cl.call("POST",
                                       "/collections/docs/points/search",
                                       rest_body(kind, i))
                assert code == 200, out
                g = got[(kind, i)]
                assert [h["id"] for h in g] == [h["id"] for h in
                                                out["result"]], (kind, i)
                assert [h["score"] for h in g] == [
                    float(np.float32(h["score"])) for h in out["result"]], (
                    kind, i)
                assert [h["payload"] for h in g] == [
                    h["payload"] for h in out["result"]], (kind, i)
        log(f"[phase18] (b) {QDRANT_SEARCHES // 2} unfiltered and "
            f"{QDRANT_FILTERED // 2} filtered gRPC answers equal to REST's "
            f"for the same request (ids in order, float32 scores, "
            f"payloads); {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        tol = _decode_step(corpus)
        # bf16 scores against float32 ones: one bf16 step (2**-8 at 1.0)
        bf16_step = 2.0 ** -8
        diff = xdiff = 0.0
        hits = 0
        exact = unit @ (qs / np.linalg.norm(qs, axis=1, keepdims=True)).T
        for i in range(QDRANT_SEARCHES):
            body = got[("search", i)]
            fresh = registry.search("docs", qs[i], limit=SERVE_K)
            assert [h["id"] for h in body] == [h["id"] for h in fresh], (
                "search ids", i)
            assert all(h["payload"] == {
                "doc": h["id"], "group": h["id"] % QDRANT_GROUPS,
                "word": words[h["id"]]} for h in body), ("payload", i)
            diff = max(diff, max(abs(a["score"] - b["score"])
                                 for a, b in zip(body, fresh)))
            xdiff = max(xdiff, max(abs(h["score"] - float(exact[h["id"], i]))
                                   for h in body))
            top = np.argsort(-exact[:, i], kind="stable")[:SERVE_K]
            hits += len({h["id"] for h in body} & set(top.tolist()))
        rec = hits / (QDRANT_SEARCHES * SERVE_K)
        assert diff <= tol, ("scores", diff, tol)
        assert xdiff <= bf16_step, ("exact scores", xdiff, bf16_step)
        assert rec >= 0.95, ("recall", rec)
        assert launches_s["streaming_topk_bf16"] > 0, "searches missed #2"
        # the filtered answers against the exact filtered ranking: ties
        # within one bf16 step may trade places
        fdiff = 0.0
        for i in range(QDRANT_FILTERED):
            g = i % QDRANT_GROUPS
            rows = np.nonzero(groups == g)[0]
            q = fq[i] / np.linalg.norm(fq[i])
            s = unit[rows] @ q
            order = np.argsort(-s, kind="stable")[:SERVE_K]
            want = [(int(rows[j]), float(s[j])) for j in order]
            body = [(h["id"], h["score"]) for h in got[("filtered", i)]]
            assert all(h["payload"]["group"] == g
                       for h in got[("filtered", i)])
            _same_hits(body, want, bf16_step, ("filtered", i))
            fdiff = max(fdiff, max(abs(a[1] - b[1])
                                   for a, b in zip(body, want)))
        log(f"[phase18] (b) search checks {time.perf_counter() - t0:.2f}s: "
            f"{QDRANT_SEARCHES} unfiltered bodies equal to the registry's "
            f"own answer in ids (max |score - reference| {diff:.6g}, "
            f"bound: #2's decode step {tol:.6g} at capacity "
            f"{corpus.capacity}), each id's score within {xdiff:.6g} of "
            f"the exact float32 cosine (bound one bf16 step "
            f"{bf16_step:.6g}), recall@{SERVE_K} {rec:.4f} against that "
            f"scan; {QDRANT_FILTERED} filtered equal to the "
            f"exact filtered answer (max |d| {fdiff:.6g}, bound one bf16 "
            f"step {bf16_step:.6g}); 429s retried {sheds['n']}")
        # -- count, scroll, retrieve, delete, the collection GETs
        t0 = time.perf_counter()
        g = int(rng.integers(0, QDRANT_GROUPS))
        flt = {"must": [{"key": "group", "match": {"value": g}}]}
        code, out, dt_count = cl.call(
            "POST", "/collections/docs/points/count", {"filter": flt})
        want_g = int((groups == g).sum())
        assert code == 200 and out["result"]["count"] == want_g, out
        seen: list = []
        offset, pages, dt_scroll = None, 0, 0.0
        while True:  # pages of half the group: a middle offset, an end
            body = {"limit": want_g // 2, "filter": flt}
            if offset is not None:
                body["offset"] = offset
            code, out, dt = cl.call("POST", "/collections/docs/points/scroll",
                                    body)
            assert code == 200, out
            dt_scroll += dt
            pages += 1
            for p in out["result"]["points"]:
                assert p["payload"]["group"] == g
                assert np.array_equal(np.asarray(p["vector"], np.float32),
                                      vecs[p["id"]]), p["id"]
            seen += [p["id"] for p in out["result"]["points"]]
            offset = out["result"]["next_page_offset"]
            if offset is None:
                break
        members = np.nonzero(groups == g)[0].tolist()
        assert seen == sorted(members, key=lambda p: (False, str(p))), (
            "scroll order")
        assert len(set(seen)) == len(seen) == want_g
        # the same count and a first scroll page over gRPC; a page of
        # QDRANT_GRPC_BATCH points: half the group (2,048 points x 1,024
        # floats, 8.5 MB) passes the 4 MiB message limit, as with grpcio
        gflt = Q._ld(2, Q._ld(1, Q._s(1, "group")
                              + Q._ld(2, Q._vi(2, g))))
        with grpcwire.Channel("127.0.0.1", qsrv.port) as ch:
            count = Q._parse(ch.unary_unary("/qdrant.Points/Count")(
                Q._s(1, "docs") + Q._ld(2, gflt), timeout=600))
            assert Q._parse(count[1][0][1])[1][0][1] == want_g, count
            raw = ch.unary_unary("/qdrant.Points/Scroll")(
                Q._s(1, "docs") + Q._ld(2, gflt)
                + Q._vi(4, QDRANT_GRPC_BATCH), timeout=600)
        code, page, _ = cl.call("POST", "/collections/docs/points/scroll",
                                {"limit": QDRANT_GRPC_BATCH, "filter": flt})
        assert code == 200, page
        grpc_page = qdrant_points(raw, 2)
        assert [p["id"] for p in grpc_page] == [
            p["id"] for p in page["result"]["points"]], "gRPC scroll"
        assert Q.dec_point_id(Q._parse(raw)[1][0][1]) == \
            page["result"]["next_page_offset"], "gRPC scroll offset"
        for a, b in zip(grpc_page, page["result"]["points"]):
            assert a["payload"] == b["payload"]
            assert np.array_equal(np.asarray(a["vector"], np.float32),
                                  np.asarray(b["vector"], np.float32))
        ids = [int(i) for i in rng.choice(n, 16, replace=False)]
        code, out, _ = cl.call("POST", "/collections/docs/points",
                               {"ids": ids})
        assert code == 200 and [p["id"] for p in out["result"]] == ids
        for p in out["result"]:
            assert p["payload"] == {"doc": p["id"], "group": p["id"] %
                                    QDRANT_GROUPS, "word": words[p["id"]]}
            assert np.array_equal(np.asarray(p["vector"], np.float32),
                                  vecs[p["id"]])
        gone = [int(i) for i in rng.choice(n, QDRANT_DELETED, replace=False)]
        code, out, _ = cl.call("POST", "/collections/docs/points/delete",
                               {"points": gone})
        assert code == 200 and out["result"]["deleted"] == len(gone), out
        code, out, _ = cl.call("POST", "/collections/docs/points/count", {})
        assert out["result"]["count"] == n - len(gone), out
        c0 = K.launch_counts()
        for pid in gone[:16]:
            code, out, _ = cl.call(
                "POST", "/collections/docs/points/search",
                {"vector": vecs[pid].tolist(), "limit": SERVE_K})
            assert code == 200 and out["result"], out
            assert not {h["id"] for h in out["result"]} & set(gone), pid
        launches_d = _launch_delta(K, c0)
        code, out, _ = cl.call("GET", "/collections")
        assert code == 200 and out["result"] == {
            "collections": [{"name": "docs"}, {"name": "multi"}]}, out
        code, out, _ = cl.call("GET", "/collections/docs")
        assert code == 200 and out["result"]["points_count"] == n - len(gone)
        assert out["result"]["config"]["params"]["vectors"] == {
            "size": vecs.shape[1], "distance": "Cosine"}, out
        log(f"[phase18] (b) count of group {g} {want_g} in "
            f"{dt_count * 1e3:.1f}ms; scroll of it in {pages} pages "
            f"{dt_scroll:.2f}s, every point once in _point_id order; the "
            f"gRPC Count and a first Scroll page of {QDRANT_GRPC_BATCH} "
            f"equal to REST's; "
            f"retrieve of 16: payloads and vectors as sent; delete of "
            f"{len(gone)}: count {n - len(gone)}, 16 searches by their own "
            f"vectors return none of them (launches "
            f"{json.dumps(launches_d)}); the collection GETs; "
            f"{time.perf_counter() - t0:.2f}s")
        # -- GraphQL's mutations against this DB, each held to the storage
        t0 = time.perf_counter()
        kept = "qdrant-docs-%d" % next(i for i in range(n) if i not in gone)
        data, _ = _gql(cl, sheds, 'mutation { createNode(labels: ["City"], '
                       'properties: {name: "Oslo", pop: 700000}) { id labels '
                       "properties } }", retry=False)
        made = data["createNode"]
        node = db.storage.get_node(made["id"])
        assert node.labels == ["City"] and made["labels"] == ["City"]
        assert node.properties == made["properties"] == {
            "name": "Oslo", "pop": 700000}
        data, _ = _gql(cl, sheds, "mutation U($id: ID) { updateNode(id: $id, "
                       "properties: {pop: 709000}) { properties } }",
                       {"id": made["id"]}, retry=False)
        assert db.storage.get_node(made["id"]).properties["pop"] == 709000
        assert data["updateNode"]["properties"]["pop"] == 709000
        data, _ = _gql(cl, sheds, "mutation R($a: ID, $b: ID) { "
                       "createRelationship(from: $a, to: $b, type: \"NEAR\", "
                       "properties: {km: 3}) { id type from to } }",
                       {"a": made["id"], "b": kept}, retry=False)
        rel = data["createRelationship"]
        edge = db.storage.get_edge(rel["id"])
        assert (edge.type, edge.start_node, edge.end_node,
                edge.properties) == ("NEAR", made["id"], kept, {"km": 3})
        data, _ = _gql(cl, sheds, "mutation D($id: ID) { "
                       "deleteRelationship(id: $id) }", {"id": rel["id"]},
                       retry=False)
        assert data == {"deleteRelationship": True}
        assert not any(e.id == rel["id"] for e in db.storage.all_edges())
        data, _ = _gql(cl, sheds, "mutation X($id: ID) { deleteNode(id: $id) "
                       "}", {"id": made["id"]}, retry=False)
        assert data == {"deleteNode": True}
        assert not db.storage.get_nodes_by_label("City")
        log(f"[phase18] (b) GraphQL createNode, updateNode, "
            f"createRelationship, deleteRelationship and deleteNode each "
            f"held to the storage; {time.perf_counter() - t0:.2f}s")
        return launches_s["streaming_topk_bf16"], rates
    finally:
        cl.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if qsrv is not None:
            qsrv.stop()
        http.stop()
        db.close()

class CardChild:
    """A process of its own on the card (``card_child``) that runs
    phases needing nothing of the parent's but their inputs, beside the
    parent's host-bound stretches, where the parent JSON-encodes or
    decodes the chain under its interpreter lock and the card is idle:
    phases 5 and 10.9's offloads, and 16(b) and 12, beside 10.1's build
    of the chain (two children; the second starts ``delay`` seconds
    later, once phase 5 has timed its kernel). Training stays in the
    parent: beside it, the parent's device owner once read a probe of
    836.226 ms, near its 1 s threshold. The child starts its own device
    owner; its kernel launches are counted in its own process. Its log
    lines are logged here when it is collected, in its order; its last
    line is its result."""

    def __init__(self, name: str, phases: list, seed: int,
                 profile_dir: str = ""):
        self.here = os.path.dirname(os.path.abspath(__file__))
        self.work = os.path.join(self.here, ".chip_scratch", f"card_{name}")
        self.out = os.path.join(self.work, "child.out")
        self.name, self.phases = name, list(phases)
        self.seed, self.profile_dir = seed, profile_dir
        self.proc = None
        self.ended: list = []
        self.timer = None

    def start(self, served: dict = None, delay: float = 0.0) -> "CardChild":
        """Write the input its phases read (phase 8's embeddings for 10.9)
        and start the child, ``delay`` seconds from now (on a timer
        thread) or at once."""
        import shutil

        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        if "109" in self.phases:
            np.save(os.path.join(self.work, "embs.npy"), np.ascontiguousarray(
                served["embs"][:CYPHER_DOCS], np.float32))
        call = (f"import chip_smoke as C; C.card_child({self.work!r}, "
                f"{self.phases!r}, {self.seed}, {self.profile_dir!r})")
        self.t_asked = time.perf_counter()
        atexit.register(self.close)
        if delay > 0:
            self.timer = threading.Timer(delay, self._spawn, (call,))
            self.timer.start()
        else:
            self._spawn(call)
        return self

    def _spawn(self, call: str) -> None:
        self.t0 = time.perf_counter()
        with open(self.out, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", call], cwd=self.here, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)

        def watch(proc=self.proc) -> None:
            proc.wait()
            self.ended.append(time.perf_counter() - self.t0)

        threading.Thread(target=watch, daemon=True).start()

    def wait(self, timeout: float = 900.0) -> float:
        """Wait for the child to exit; returns the seconds waited."""
        t0 = time.perf_counter()
        if self.timer is not None:
            self.timer.join()
        self.proc.wait(timeout=timeout)
        return time.perf_counter() - t0

    def state(self) -> str:
        """For the log lines of the phases it may run beside: their
        readings are not taken alone while it runs."""
        if self.proc is None:
            return f"{self.name}'s card child not started"
        if self.proc.poll() is None:
            return (f"{self.name}'s card child running "
                    f"({time.perf_counter() - self.t0:.1f}s after its start)")
        return (f"{self.name}'s card child ended "
                f"{self.ended[0] if self.ended else 0.0:.1f}s after its "
                f"start")

    def collect(self, timeout: float = 900.0) -> dict:
        """Wait for the child; it must exit 0 with its result as the last
        line. Its lines are logged here (those not of a phase tagged with
        its name); returns the result."""
        waited = self.wait(timeout)
        with open(self.out) as f:
            lines = f.read().split("\n")[:-1]
        assert self.proc.returncode == 0, (self.name, self.proc.returncode,
                                           "\n".join(lines[-60:]))
        for line in lines[:-1]:
            log(line if line.startswith("[phase") else
                f"[card child {self.name}] {line}")
        result = json.loads(lines[-1])
        log(f"[card child {self.name}] phases {self.phases} exited 0 "
            f"{self.ended[0] if self.ended else 0.0:.1f}s after its start; "
            f"waited {waited:.1f}s for it; its device owner "
            f"{json.dumps(result['owner'])}")
        return result

    def close(self) -> None:
        import shutil

        if self.timer is not None:
            self.timer.cancel()
            self.timer.join()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def states(*children) -> str:
    """The states of the children on the card, for a log line."""
    return ", ".join(c.state() for c in children if c is not None) or \
        "no child on the card"


def card_child(work: str, phases: list, seed: int, profile_dir: str) -> None:
    """``CardChild``'s process: the parent's matmul precision, its own
    device owner, then each of ``phases`` ("5", "109" for 10.9's
    offloads, "12", "16b", "19") in order, as the parent would run it.
    Its last line is the result: phase 5's kernel entries and launches,
    phase 19's numbers, the generated tokens and sheds of its engines,
    its owner's state
    (READY throughout, no degrade). Then it stops the owner and leaves
    with ``os._exit`` (see ``qdrant_child``)."""
    import torch

    from nornicdb_tpu_torch.ops import kernels as K
    from nornicdb_tpu_torch.ops import kernels_ref as R

    exact_matmuls()
    start_device_owner()
    result: dict = {}
    for ph in phases:
        t0 = time.perf_counter()
        if ph == "5":
            result["entries"], result["counts"] = phase_generation(
                K, R, seed, profile_dir)
        elif ph == "109":
            phase_cypher_offloads(K, np.load(os.path.join(work, "embs.npy")),
                                  seed)
        elif ph == "12":
            phase_graph(seed)
        elif ph == "16b":
            phase_gds_write(K, seed)
        elif ph == "19":
            result["decay"] = phase_decay(K, decay_vectors(seed), seed)
        else:
            raise ValueError(ph)
        gc.collect()
        torch.cuda.empty_cache()
        name = {"16b": "16] (b)", "109": "10.9] (b)-(d)"}.get(ph, ph + "]")
        log(f"[phase{name} {time.perf_counter() - t0:.1f}s in the card "
            f"child")
        probe_mark("phase " + name.replace("]", ""))
    mgr = OWNER["manager"]
    st = mgr.stats()
    result["owner"] = {k: st[k] for k in (
        "state", "probes_total", "degrades_total", "acquire_timeouts_total")}
    result["owner"]["probe_latency_max_ms"] = st["probe_latency_max_s"] * 1e3
    result["gen_counted"] = GEN_COUNTED
    result["predicted_sheds"] = PREDICTED_SHEDS
    assert st["state"] == "READY" and st["degrades_total"] == 0 and \
        st["acquire_timeouts_total"] == 0, st
    print(json.dumps(result), flush=True)
    mgr.stop()
    sys.stderr.flush()
    os._exit(0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace 16 batches of 16 queries, "
                    "after phase 5 eight generation requests, in phase 8 "
                    "about 32 embed packs, and in phase 11 two train steps "
                    "of each model, with torch.profiler (device busy "
                    "share, per-op tables)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import nornicdb_tpu_torch

        # the port under test is the checkout's, never an installed copy
        if os.path.dirname(os.path.dirname(
                os.path.abspath(nornicdb_tpu_torch.__file__))) != here:
            raise ImportError(f"found {nornicdb_tpu_torch.__file__} instead")
        from nornicdb_tpu_torch.ops import _build
        from nornicdb_tpu_torch.ops import kernels as K
        from nornicdb_tpu_torch.ops import kernels_ref as R
        from nornicdb_tpu_torch.ops import similarity as S
        from nornicdb_tpu_torch.search import SearchConfig, SearchService
        from nornicdb_tpu_torch.storage import Node
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    exact_matmuls()
    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[card] {smi}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    # -- build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s " + json.dumps(secs))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for name, rep in _build.ptxas_reports.items():
            f.write(f"== {name}\n{rep}\n")
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {line.strip()}")

    # -- the device owner, before any consumer touches the card
    start_device_owner()

    # -- data
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    data = make_data(args.seed, N, DIMS)
    ids = [f"v{i}" for i in range(N)]
    q_rows = rng.choice(N, size=1024 + 256, replace=False)
    qs_kern = make_queries(rng, data, q_rows[:1024])
    serve_rows = q_rows[1024:]
    qs_serve = make_queries(rng, data, serve_rows)
    log(f"[data] {N}x{DIMS} in {time.perf_counter() - t0:.1f}s")
    k = K_TOP
    sample = np.arange(0, len(qs_serve), 8)  # 32 queries scored for recall

    # -- phase 2 setup: service + bulk load (+ first full upload)
    svc = SearchService(config=SearchConfig(batching_enabled=True), device=device)
    batch_log: list[tuple[float, float, int]] = []  # (start, end, queries)
    inner = svc._batched_corpus_search

    def timed_batch(queries, kk, min_sim):
        t = time.perf_counter()
        try:
            return inner(queries, kk, min_sim)
        finally:
            batch_log.append((t, time.perf_counter(), len(queries)))

    svc._batched_corpus_search = timed_batch
    t0 = time.perf_counter()
    svc.index_vectors(ids, data)
    corpus = svc.corpus()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        sync()
    log(f"[load] add_batch + upload {time.perf_counter() - t0:.1f}s, "
        f"capacity {corpus.capacity}, sync {corpus.sync_stats.as_dict()}")

    # -- phase 1: kernels vs plain versions at the serving shapes
    t0 = time.perf_counter()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        c_i8, c_scale = K.quantize_rows(dev)
        entries = phase_kernels(K, R, dev, valid, c_i8, c_scale, qs_kern, k,
                                REPS)
        del c_i8, c_scale
    log(f"[phase1] kernels vs plain: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_int8_10m(K, R, args.seed, k, REPS)
    log(f"[phase1] int8 kernel at 10M rows: {time.perf_counter() - t0:.1f}s")

    # -- phase 2: the serving path (batched vector_candidates + writes).
    # Removed: the own rows of queries outside the recall sample, each in
    # its query's true top-k, so a leak would show.
    removed = {f"v{r}" for r in serve_rows[1::8]}
    for rid in removed:
        svc.remove_node(rid)

    extra = rng.standard_normal((48, DIMS), dtype=np.float32)

    def writes() -> None:
        # random rows score ~0 against every query: never in a top-k
        for i in range(48):
            svc.index_node(Node(id=f"new{i}", embedding=extra[i]))
            if i % 8 == 7:
                svc.remove_node(f"new{i - 4}")
            time.sleep(0.002)

    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    p0 = corpus.sync_stats.patches
    run = drive_service(svc, qs_serve, k, writes)
    counts2 = K.launch_counts()
    dispatches = corpus.sync_stats.device_dispatches - d0
    patches = corpus.sync_stats.patches - p0
    bstats = svc.ensure_batcher().stats.as_dict()
    served = [r for r in run["results"]]
    leaked = {i for res in served for i, _ in res} & removed
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve[sample], dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec2 = recall([served[i] for i in sample], gt_ids)
    batch_ms = [(b - a) * 1e3 for a, b, _ in batch_log]
    phase2 = {"qps": len(qs_serve) / run["wall"],
              "p50": np.median(run["lat"]) * 1e3,
              "p99": np.percentile(run["lat"], 99) * 1e3}
    log(f"[phase2] {len(qs_serve)} queries in {run['wall']:.3f}s "
        f"qps={len(qs_serve) / run['wall']:.1f} "
        f"client p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms "
        f"batch p50={np.median(batch_ms):.2f}ms "
        f"dispatches={dispatches} patches={patches} batcher={bstats} "
        f"launches={counts2} recall@{k}={rec2:.4f}")
    log_timeline(run, batch_log, out_dir)
    assert counts2["streaming_topk_bf16"] > 0, (
        "serving path missed the bf16 kernel")
    assert dispatches < len(qs_serve), ("no fusion", dispatches)
    assert patches >= 1, "dirty-block patch sync never ran"
    assert not leaked, ("removed ids served", leaked)
    assert rec2 >= 0.95, ("serving recall", rec2)
    if args.profile:
        profile_search(corpus, qs_serve, k, 16, out_dir)
    svc.shutdown()
    # `inner` is a bound method of the service: while it lives, so do the
    # service and its 3.8 GiB corpus buffer
    del svc, corpus, dev, valid, inner, timed_batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 3: int8-mirrored corpus
    t0 = time.perf_counter()
    qc = S.DeviceCorpus(dims=DIMS, quantize=True, device=device)
    qc.add_batch(ids, data)
    qc.search(qs_serve[:1], k=k)  # first sync: upload + quantize
    log(f"[phase3] int8 corpus load {time.perf_counter() - t0:.1f}s")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res3 = []
    for i in range(0, len(qs_serve), 32):
        res3 += qc.search(qs_serve[i:i + 32], k=k)
    wall3 = time.perf_counter() - t0
    counts3 = K.launch_counts()
    with qc._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve[sample], dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec3 = recall([res3[i] for i in sample], gt_ids)
    log(f"[phase3] {len(qs_serve)} queries in batches of 32: {wall3:.3f}s "
        f"qps={len(qs_serve) / wall3:.1f} launches={counts3} recall@{k}={rec3:.4f}")
    assert counts3["streaming_topk_int8"] > 0, (
        "int8 path missed the int8 kernel")
    assert rec3 >= 0.95, ("int8 recall", rec3)

    # -- phase 4: extract-kernel epilogue == sort epilogue
    S.TOPK_EPILOGUE = "sort"
    ref4 = qc.search(qs_serve[:32], k=k)
    K.reset_launch_counts()
    S.TOPK_EPILOGUE = "pallas"
    t0 = time.perf_counter()
    got4 = qc.search(qs_serve[:32], k=k)
    wall4 = time.perf_counter() - t0
    counts4 = K.launch_counts()
    S.TOPK_EPILOGUE = "sort"
    log(f"[phase4] extract epilogue batch of 32: {wall4 * 1e3:.2f}ms launches={counts4}")
    assert counts4["extract_topk"] > 0, (
        "extract epilogue never launched")
    assert got4 == ref4, "extract epilogue differs from sort"
    del qc, dev, valid
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 8: embed serving at full width, then search over it
    t0 = time.perf_counter()
    served = phase_embed(K, args.seed, k, out_dir if args.profile else "")
    log(f"[phase8] {time.perf_counter() - t0:.1f}s")
    probe_mark("phase 8")

    # -- phase 10: hybrid search over phase 8's corpus in the durable
    # chain; phase 9: a checkpoint and GraphRAG answers retrieving through
    # it; then the chain is closed (its close-time snapshot for phase 14)
    import shutil

    shutil.rmtree(CHAIN_DIR, ignore_errors=True)
    os.makedirs(CHAIN_DIR)
    # -- phases 5 and 10.9's offloads, and 16(b) and 12: two card
    # children beside 10.1's build (host code: the chain JSON-encodes
    # every record; the card idles), waited for before 10.2
    prof = out_dir if args.profile else ""
    gen5 = CardChild("5-109", ["5", "109"], args.seed, prof).start(served)
    graphs = CardChild("16b-12-19", ["16b", "12", "19"], args.seed,
                       prof).start(
        delay=CHILD_DELAY_S)
    try:
        t0 = time.perf_counter()
        hybrid = phase_hybrid(K, args.seed, served, beside=(gen5, graphs))
        log(f"[phase10] {time.perf_counter() - t0:.1f}s")
        probe_mark("phase 10")
        db = hybrid["db"]
        res5 = gen5.collect()
        gen5.close()
        graphs.collect()
        graphs.close()
        entries += res5["entries"]
        counts5 = res5["counts"]
        log(f"[phase5] the card child's generated tokens "
            f"{json.dumps(res5['gen_counted'])} and predicted-deadline "
            f"sheds {json.dumps(res5['predicted_sheds'])} (its own registry)")
        # 14b's replay and 14c's crash children, beside phases 6 to 14
        start_children(args.seed)
        # -- phases 6 and 7 over a second service on phase 2's vectors,
        # after phase 10 so that 14b's replay child starts sooner
        t0 = time.perf_counter()
        svc = SearchService(config=SearchConfig(batching_enabled=True),
                            device=device)
        svc.index_vectors(ids, data)
        del data
        gc.collect()
        corpus = svc.corpus()
        with corpus._borrow_device() as (dev, valid, _, _, _):
            sync()
        log(f"[phase7] load + upload {time.perf_counter() - t0:.1f}s, "
            f"capacity {corpus.capacity}")
        t0 = time.perf_counter()
        with corpus._borrow_device() as (dev, valid, _, _, _):
            entries6, counts6 = phase_fused_cosine(K, R, dev, valid,
                                                   qs_kern, k, REPS)
        del dev, valid
        entries = entries6 + entries
        log(f"[phase6] {time.perf_counter() - t0:.1f}s")
        probe_mark("phase 6")
        t0 = time.perf_counter()
        phase_ivf(svc, corpus, qs_serve, k, phase2)
        svc.shutdown()
        del svc, corpus
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase7] {time.perf_counter() - t0:.1f}s")
        probe_mark("phase 7")
        t0 = time.perf_counter()
        phase_cypher(K, db, served, args.seed)
        log(f"[phase10.9] {time.perf_counter() - t0:.1f}s")
        probe_mark("phase 10.9")
        t0 = time.perf_counter()
        phase_gds_apoc(K, db, args.seed)
        log(f"[phase16] {time.perf_counter() - t0:.1f}s")
        probe_mark("phase 16")
        qdrant18 = children = decay_cli = None
        try:
            t0 = time.perf_counter()
            phase_rag(K, args.seed, served, hybrid)
            log(f"[phase9] {time.perf_counter() - t0:.1f}s")
            probe_mark("phase 9")
            # -- phase 17: the serve surface over this DB, then the command
            # (its children start once (a) is done)
            t0 = time.perf_counter()
            phase_serve(K, db, served, args.seed)
            log(f"[phase17] (a) {time.perf_counter() - t0:.1f}s")
            t1 = time.perf_counter()
            children = ServeChildren().start()
            atexit.register(children.close)
            phase_serve_cli(K, children)
            log(f"[phase17] (b) {time.perf_counter() - t1:.1f}s")
            log(f"[phase17] {time.perf_counter() - t0:.1f}s")
            probe_mark("phase 17")
            # -- phase 18: GraphQL over this DB here, alone, then Qdrant
            # REST over a fresh DB in a child on the card (collected after
            # phase 14)
            t0 = time.perf_counter()
            phase_graphql(K, db, served, args.seed)
            log(f"[phase18] (a) {time.perf_counter() - t0:.1f}s, alone; "
                f"(b)'s child starts now")
            qdrant18 = QdrantChild(args.seed).start(served)
            atexit.register(qdrant18.close)
            probe_mark("phase 18(a)")
            # phase 19's decay commands over 17(b)'s data directory, in
            # the background beside the close
            decay_cli = children
        finally:
            fired = hybrid["learned"]["fired"]
            t0 = time.perf_counter()
            while len(fired["end"]) < len(fired["start"]):
                # a recluster in flight finishes before the DB closes
                assert time.perf_counter() - t0 < 300, "recluster hung"
                time.sleep(0.1)
            log(f"[phase10] after phase 9: "
                + cluster_report(fired, hybrid["learned"]["t0"]))
            t0 = time.perf_counter()
            if decay_cli is not None:
                decay_cli.start_decay()
            beside = states(qdrant18)
            db.close()
            # phase 9 set the process default the engine was built from
            from nornicdb_tpu_torch import genserve

            genserve.configure(None)
            snap = os.path.join(CHAIN_DIR, "db10", "wal", "snapshot.json")
            probe_mark("phase 10's close")
            log(f"[phase10] db.close() {time.perf_counter() - t0:.2f}s "
                f"(the embed worker, phase 8's engine, the search service "
                f"and the generation engine stopped; close-time snapshot "
                f"{os.path.getsize(snap)} bytes; at its start {beside}, "
                f"at its end {states(qdrant18)})")
            if decay_cli is not None:
                log("[phase19] " + decay_cli.collect_decay(
                    SERVE_DOCS + SERVE_QDRANT_POINTS))
            if children is not None:
                children.close()
    finally:
        served["engine"].stop()
    texts8, rate8 = served["texts"], served["embeddings_per_s"]
    record = hybrid["record"]
    del served, hybrid, db
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 11: training, distillation and the train command, here
    # (beside another process's training the device owner's probe once
    # read 836.226 ms), beside 18(b)'s child while it runs
    t0 = time.perf_counter()
    beside = states(qdrant18)
    phase_train(args.seed, texts8, rate8, prof)
    del texts8
    log(f"[phase11] {time.perf_counter() - t0:.1f}s; at its start "
        f"{beside}, at its end {states(qdrant18)}")
    probe_mark("phase 11")

    # -- phase 14: the storage chain, from disk onto the card, beside
    # 18(b)'s child while it runs
    t0 = time.perf_counter()
    beside = states(qdrant18)
    phase_storage(K, args.seed, record)
    del record
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase14] {time.perf_counter() - t0:.1f}s; at its start {beside}, "
        f"at its end {states(qdrant18)}")
    probe_mark("phase 14")

    # -- phase 18(b): the Qdrant child, which ran beside phase 10's close
    # and phases 11 and 14
    t0 = time.perf_counter()
    try:
        qdrant18.collect()
    finally:
        qdrant18.close()
    log(f"[phase18] (b) collected after phase 14, waited "
        f"{time.perf_counter() - t0:.1f}s")
    probe_mark("the wait for 18(b)")

    # -- phase 15: the device owner's transitions (private managers)
    t0 = time.perf_counter()
    phase_device_owner(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase15] {time.perf_counter() - t0:.1f}s")
    probe_mark("phase 15")

    # -- phase 13: the registry after the whole run
    t0 = time.perf_counter()
    phase_registry()
    log(f"[phase13] {time.perf_counter() - t0:.1f}s")

    # -- report
    launches = {"streaming_topk_bf16": counts2["streaming_topk_bf16"],
                "streaming_topk_int8": counts3["streaming_topk_int8"],
                "extract_topk": counts4["extract_topk"], **counts5, **counts6}
    for e in entries:
        e["launches"] = launches[e.pop("counter")]
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    log(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
