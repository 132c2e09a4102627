#!/usr/bin/env python3
"""Drive the PyTorch port (``seldon_core_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card visible

Phases, each of which raises on failure (no phase catches its own):

1. build every CUDA kernel under ``seldon_core_tpu_torch/csrc/`` with nvcc
   for sm_90a (into the git-ignored ``build/kernels/``, one nvcc per source,
   all started together), and count the Hopper instructions in the built
   libraries (``HGMMA``, ``UTMALDG``): the flash kernel must hold both,
   the W8A16 kernel both and ``HMMA`` (its mma.sync body for ragged shapes);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, as contiguous tensors and as the views
   of one fused QKV projection that BERT hands it (plus the causal and
   ragged cases), with limits scaled to each case's output, show that two
   planted faults fail the same check, and time kernel, plain version and
   the library call that computes the same function (CUDA events, median of
   25 single calls, each queued behind a device sleep so host launch time is
   not counted; inputs stay warm in L2, as they are when the attention
   follows the QKV projection; the bucket-8 cases are also timed with a cold
   L2, and the host cost of a call is measured);
3. serve BERT-base (hidden 768, 12 layers, 12 heads, seq 512, bfloat16,
   random weights from seed 0) through the port's REST ingress from
   ``seldon_core_tpu_torch/deployments/bert_base_flash.json``, with the
   launch counter proving the attention ran through the kernel, the answers
   held against the same weights run with blockwise attention and with the
   kernel's plain version, and three wrong attentions shown to fail that
   check; then one request at seq 4096 under the ``auto`` policy, which
   must launch it too;
4. serve the five BASELINE deployments from
   ``seldon_core_tpu_torch/deployments/`` through REST: iris, MNIST and the
   iris A/B test as JSON (answers against the port's own forward on the
   CPU; the A/B routing against ``random.Random(1337)``); the 3x ResNet50
   average ensemble as one FusedUnit fed uint8 npy bodies at batch 1 and
   128 (answers against the same bf16 weights walked unfused; per member,
   bf16 logits against float32 on the card and float32 against the CPU,
   with a stem padded (3, 3) and a max-pool padded (1, 1) shown to fail;
   fused, sequential and unfused forwards timed); the transformer ->
   epsilon-greedy -> 2x BERT-base DAG at seq 128 as JSON ids (12 kernel
   launches per request, answers against blockwise attention, and a
   feedback that moves only the routed arm); on iris the reference's
   engine surface (``/pause`` then ``/ready`` 503, ``/unpause`` then 200,
   by GET and POST; urlencoded and multipart ``json=`` predictions equal to
   the JSON body's answer; a form without the field 400 code 101) and
   ``load_predictor`` refusing a childless ROUTER with the reference's text.
5. serve the four decoder deployments of
   ``seldon_core_tpu_torch/deployments/`` through REST: ``tiny_gpt`` (the
   fused greedy ``generate``, buckets 2 and 8) against the port's forward and
   ``reference_generate`` on the CPU; ``gpt_continuous_batching`` (8 slots)
   under 16 staggered requests with mixed ``max_new_tokens`` against the
   fused ``generate`` on the card (float32, TF32 off), one SSE stream
   against its buffered reply, no new dispatch key after warmup, an EOS
   deployment retiring early, and the per-step device time;
   ``tiny_gpt_paged_kv`` (int8 pages, prefix reuse, chunked prefill) under
   shared-prefix traffic, with the int8 pool's teacher-forced logits against
   an fp pool's and the allocator's audit; ``gpt2_small_long_prompt``
   (GPT-2-small widths, a 4096-token prompt, bf16), whose prefill must
   launch the causal flash kernel once per layer, with its prompt (and
   first-token) logits and greedy ids held against blockwise causal attention and the
   kernel's plain version, two wrong attentions shown to fail, and the
   request's time split into prefill, kernel and decode.
   Greedy ids of two paths may part only at a near-tie: at the first
   token where a row diverges, the reference path's top logit must be
   within the tie margin of the served token's.
6. serve the three speculative deployments of
   ``seldon_core_tpu_torch/deployments/`` through REST — ``tiny_gpt_speculative``
   (a 1-layer draft, k=4), ``tiny_gpt_tree_speculation`` (tree "2,2,1,1",
   accept floor 0.3, prefix reuse) and ``gpt2_small_speculative``
   (GPT-2-small widths, a 2-layer draft, k=4, bf16), plus a tree copy of
   the last ("2,2,1,1": a verify 15 wide) and a float32 copy: 16 staggered
   requests with mixed budgets, one opted out (``spec_k=0``), served by the
   speculative server and by a copy with speculation off in turns; every
   greedy row held to the plain scheduler's and to the fused ``generate``'s
   under the tie rule, one SSE stream against its buffered reply, no new
   dispatch key after warmup; per deployment the rounds, tokens per target
   dispatch, accept rate, mean accepted per round, ms per token against the
   plain scheduler, and one round's wall, device time (draft and verify)
   and host share. Three planted faults: a draft from another seed (ids
   unchanged, accept rate lower), an acceptance that keeps one draft token
   past the first mismatch and a tree commit that writes a sibling's K/V
   (both must fail the id check). Then the feature draft the same way:
   ``tiny_gpt_feature_draft``, ``gpt2_small_feature_draft`` (the
   EAGLE-style head, tree "4,3,2,1", accept floor 0.3, bf16) and a copy of
   the latter at "2,2,1,1" with no floor, each with the four feature keys
   (``step_f``, ``chunk_f``, ``draft_feat``, ``ftree_verify``) and the
   carry check: after greedy requests, speculating and opted out, each
   slot's carried feature against the target's ``sequence_hidden`` at its
   last consumed position, recomputed on the card (``CARRY_TOL``); a
   ``step_f`` that leaves the carry stale must fail it, and an
   ``ftree_verify`` that keeps a draft token past a mismatch the id
   check. The speculation path launches no flash kernel (counted).
7. int8 weights and the resilience layer: the W8A16 kernel
   (``csrc/int8_matmul.cu``) against its plain version in bf16 and float32
   at BERT-base's served projections at bucket 32 and bucket 1, iris's (M,
   4 -> 3), the wgmma body's edges (M % 128 != 0, K % 64 != 0, N not a
   multiple of the tile) and three stacked members (through the vmap rule,
   a shared input and per-member rows, at K 768 and 776), each case on the
   body ``select_body`` must name for it (counted per body), with scales
   applied per row and one dropped K tile shown to fail every case, each
   case timed beside its plain version, ``torch.addmm`` /
   ``torch.baddbmm`` on the pre-dequantized weights and, where it took
   the wgmma body, the mma.sync body on the same inputs; the wrapper's host
   cost per call; the ``bert_int8`` deployment through REST (49 launches
   per forward, counted: 48 on the wgmma body, the head on the mma body;
   probabilities against the bf16 deployment and the CPU; resident
   parameter bytes; a profiler breakdown at bucket 32);
   ``iris_fallback_breaker`` on the card with faults
   installed (fallback and breaker, a deadline tag's 504, a breakered node
   without fallback answering 500 then 503 with Retry-After, and
   ``batch_across_requests`` false walking each request alone).
8. telemetry, which every phase ran with at its defaults: 50 one-row
   requests each on ``bert_base_flash`` and the DAG, each with its own W3C
   ``traceparent`` and the ``trace`` tag, every ``/traces/{puid}`` a tree
   (an ingress root continuing the header, one batcher span, one span per
   unit call, children inside their parents) and ``/metrics`` counts rising
   by exactly the requests and unit calls (and one DAG feedback);
   ``iris_fallback_breaker`` with a failing primary, its retry, fault,
   degraded and breaker metrics against the traces and the fault schedule;
   ``gpt_continuous_batching``'s ``/decode/flight`` frames against the
   served tokens, ``/decode/health``, ``/decode/profile`` (``?hz`` capped
   at 200), an SLO copy's attainment counters; the decode round's split
   (busy against gap, enqueue against readback per family, the gap by
   phase) with ``ENGINE_FLIGHT_SYNC_TIMING`` off and on, also for
   ``gpt2_small_speculative``; the step's wall with the recorder on and
   off, and an idle step direct, through the worker and the hop alone;
   iris and the DAG under the load generator at 16 users with telemetry on
   and off, in turns. A dropped span, a metric off by one and a frame that
   loses a token must each fail their check.
9. the pipelined decode rounds and the KV tiers: ``gpt_continuous_batching``
   under phase 5's traffic, ``gpt2_small_speculative``, its tree copy, its
   copy with speculation off and ``gpt2_small_feature_draft`` under phase
   6's, each served on the
   pipelined loop and the serial one in turns (pipelined, serial, serial,
   pipelined): greedy rows bit for bit between the loops and held to the
   fused ``generate``; a sampled run (every request at once) identical
   between the loops; frames with overlap in every pipelined round and
   none in a serial one; no new dispatch key; per deployment and loop the
   round's wall, busy, gap and overlap, the step's (or verify's) enqueue
   and readback and tokens/s; an idle step queued from the loop's thread
   against through the worker; the pipelined loop's readback polled within
   its bound, synchronized on the worker at once and polled to the end, in
   turns, under the same traffic. A decision whose caller leaves during the
   flight is rolled back, and a pool of two slots' pages defers a head;
   an admission installed before the readback walk and a chunk plan taken
   with a stale key must fail their checks. Then ``gpt2_small_kv_tier``
   through REST: a prompt served cold, warm from the device, promoted
   from host, then from the store (warm rows bit for bit, each promoted
   entry's pages the tier's bytes and the tier's bytes those the entry
   held on the card while warm), a promotion inside an overlap window (bit
   for bit its device-warm row), a corrupt store entry served cold, a
   promotion's wall per page against the cold prefill's, and a promotion
   written one page off and a demotion read one page off that must fail
   their byte checks; an int8-pool copy of ``tiny_gpt_paged_kv`` held to
   its own cold output; and a copy of ``gpt2_small_feature_draft`` with
   the host tier and a one-entry index, whose prompt promoted from host
   serves its device-warm row bit for bit, the head's window opened past
   the reused span.
10. learning: copies of ``iris`` (float32, SGD, lr 0.5) and ``mnist``
   (bf16, Adam, lr 1e-3) with ``finetune`` on, each taking 6 labelled
   feedbacks of 8 rows through REST ``/api/v0.1/feedback`` while a client
   predicts a probe without pause: every answer equal, bit for bit, to the
   eager forward of one published parameter version (the last answer to
   the final one's), the taught class's probability up, no dispatch key
   after warmup, and a planted update that copies half the leaves failing
   that check; ms per train step. Then ``distill(features=True)`` on the
   card at GPT-2-small width (the target of ``gpt2_small_feature_draft``,
   128-token prompts, 64 on-policy tokens, 600 steps, about 30 s), its
   report and seconds per step, and the deployment served with the
   distilled head (``distilled=`` a checkpoint in a temporary directory)
   beside speculation off under phase 6's traffic: greedy rows equal, the
   accept rate, accepted per round, tokens per target dispatch and ms per
   token. Neither kernel launches in this phase (counted): no gradient
   passes through a kernel, whose wrapper refuses autograd.
11. model sources and user code: BERT-base-geometry weights from a seed
   written under the git-ignored ``model_store/`` as a ``save_pretrained``
   directory (``config.json``, ``model.safetensors`` with HF key names, a
   tanh pooler and a 2-label head) and as a ``file://`` checkpoint of
   ``zoo://bert_base`` seed 0, each read back on the host and held to what
   was written; ``bert_base_hf`` and ``bert_base_file`` served beside phase
   3's ``bert_base_flash`` (12 flash launches a request each, 0 keys after
   warmup, the checkpoint's answers bit for bit zoo://bert_base's, the HF
   answers against the eager plain forward on the same weights, device
   busy per forward and the 1-user p50 against ``bert_base_flash``);
   ``bert_base_hf_int8`` through phase 7c's checks (50 W8A16 launches a
   forward: the pooler's is the 50th); ``fraud_outlier`` (tags against
   the stored statistics), ``iris_shadow`` beside its primary alone in
   turns (every primary answer equal, agreement counted on /metrics, then
   a failing candidate planted that must change no answer and count every
   mirror as a disagreement) and ``mnist_cnn`` (a user's torch CNN trained
   on the card at build: accuracy, its forward against the CPU's, the ms
   a request holds the event loop); ``gbm.json`` where sklearn is at hand,
   else a line saying why it is skipped.
12. the replicated decode fleet: ``gpt2_small_replicated`` (two GPT-2-small
   scheduler replicas of 8 slots on the card's one copy of the parameters,
   the prefix-affinity router, health polled every 20 ms, autoscale to 3
   at queue depth 8) through REST on the pipelined loop, beside one-replica
   copies at 8 slots and at 16 (twice the pages and prefix entries), in
   turns. Traffic: 8 system prompts of 96 tokens, each opened by one
   request (the 8 staggered by 4 ms and awaited), then 3 sharers each (the
   24 staggered by 4 ms, system prompt by system prompt), 32 distinct
   tokens a prompt and budgets of 8 to 32, every request an SSE stream.
   12a: every greedy row bit for bit the 8-slot copy's, held to the 16-slot
   copy's and the fused ``generate``'s under the tie rule, every stream its
   reply; exactly one cold prefill per system prompt and no sibling pull
   but for a shed; 0 keys after warmup; ``/metrics`` routes rising by the
   requests; tokens/s and TTFT p50/p99 of each, each replica's round wall,
   busy and host share; the fleet under round robin paying more cold
   captures with sibling pulls, and a router planted to ignore the prefix
   key failing the count. 12b: on replica 0 mid-traffic a hung round
   (evicted within (threshold + 1) polls plus 20 ms of its hang), a window
   of dropped probes and an induced OOM, each evicting, migrating and
   readmitting it half-open with every row bit for bit its uninterrupted
   row and each state shown on ``/decode/fleet`` and ``/decode/health``;
   on the idle fleet, both loops, a request killed after 0, 1, 16 and 31
   tokens resuming bit for bit, its cost against its uninterrupted wall,
   and a replay one token short and a re-streamed replay failing the
   stream check. 12c: ``POST /decode/drain?replica=1`` under traffic (rows
   intact, replica 1 ``down``, its system prompts device hits on replica
   0); ``?replica=x`` 400, and on the 8-slot copy ``/decode/fleet`` 404 and
   ``/decode/drain`` 400. 12d: traffic holding replica 0's queue past 8
   boots replica 2 pre-seeded through the ``file://`` store under
   ``fleet_spill_store/``: its pages the spilled bytes and replica 0's, its
   first request of a spilled system prompt a prefix hit, 0 keys after its
   warmup; its boot split and memory. A preseed written one page off must
   fail the byte check. Neither kernel launches in the phase (counted).

13. the split data plane: 13a ``bert_base_flash`` booted through
   ``tools/stack.build_gateway_stack`` behind the port's OAuth gateway
   (``gateway_routes`` on a port of their own, a ``file://`` audit sink):
   tokens by Basic auth and by form, 20 one-row Bearer requests each bit
   for bit the predictor's own ingress's answer with 12 flash launches,
   the audit read back by ``tools/audit_tail``, the load generator with
   ``--oauth-key`` against the gateway and without against the ingress in
   turns (1 and 16 users), then a missing token, a wrong secret, a
   rotated-out key's token (a gateway planted to skip that revocation
   must fail), a deployment whose engine is gone and a removed one, each
   with the JAX gateway's status and code. 13b ``full_dag_bert`` split:
   its two BERT-base arms (seq 128, bf16, seeds 0 and 1) served by unit
   servers in processes of their own (the server CLI, ``--warmup``), the
   engine (``full_dag_bert_remote.json``, ports written in) behind the
   gateway with ``full_dag_bert``'s OAuth client; 16 requests to it and to
   the in-process ``full_dag_bert`` in turns, routes and probabilities
   equal request by request; a feedback moving only the routed arm's
   reward; the same arms as in-process unit servers behind a third engine
   (12 flash launches a request, counted); one request's engine unit span
   against the unit server's ingress span; the load generator on the split
   and the in-process DAG in turns; the arms' endpoints swapped and a
   client counting 4xx against the breaker (after 5 answers of 400 to a
   malformed body) planted, each failing its check. 13c the microservice
   CLI serving ``examples/models/torch_mnist_cnn`` in a process of its
   own, driven by ``tools/contract.py`` and consumed by a ``RemoteUnit``
   (bit for bit the class in-process), then ``/route`` and
   ``/send-feedback`` on a router class. 0 new dispatch keys after warmup
   in this process's servers.
14. gRPC (``serve_grpc``), after printing the host's ``grpc`` and
   ``google.protobuf`` versions (a missing one, or ``_pb2`` modules that
   cannot load, fail the phase). 14a ``bert_base_flash`` with its gRPC
   port beside REST: 20 one-row id requests by ``Seldon/Predict`` as
   tensor, each answer bit for bit the REST ingress's, 12 flash launches
   each; ``seldon.protos`` and ``Model/Predict`` the same; ``ServerInfo``
   "gpu" and the card count; an npy ``binData`` request answered in
   ``binData``; gRPC callers (``chip_smoke.py --grpc-load``, processes of
   their own, a closed loop each on its own channel) against the REST
   load generator in turns, at 1 and 16 users. 14b the same server behind
   the gateway over gRPC (``aio`` and ``sync``) and gRPC-Web: 20 requests
   each way bit for bit the REST answers, 20 audit records each way; a
   missing and a revoked token refused with code 205 (inside a
   ``grpc-status:0`` frame over gRPC-Web), a malformed frame
   ``grpc-status:3``; 1-user p50/p99 each way against the REST gateway, in
   turns. 14c ``full_dag_bert`` split over gRPC: the arms as unit-server
   processes serving REST and gRPC (phase 13's end with its event loop,
   so they are not shared), the engine of a ``type: GRPC`` copy of
   ``full_dag_bert_remote.json`` behind the gRPC gateway, a REST split
   engine and the in-process DAG beside it; 16 requests to the three:
   routes and probabilities equal; a feedback by gRPC; one request's hop
   from its trace (the unit server's ingress span continuing the gRPC
   metadata's ``traceparent``); one arm's process killed (a transport
   failure, the cached channel dropped, the breaker counting it) and
   started again on the same gRPC port, the same engine serving the next
   request. 14d the microservice CLI in ``GRPC`` mode serving
   ``torch_mnist_cnn`` (no REST port), driven by ``tools/contract.py``
   with ``--grpc`` and consumed by a GRPC ``RemoteUnit`` (bit for bit the
   class in-process); ``Router.Route`` and ``Router.SendFeedback`` on a
   router class. Planted, each failing its check: a codec dropping
   ``meta.routing`` (14c's routes), a gateway taking a missing token
   (14b's refusal), a ``RemoteUnit`` whose transport check never matches
   (14c's dropped channel). 0 new dispatch keys after warmup.
15. the all-in-one platform (``serve_platform``): one ``Platform``
   process on the card with its data plane on one port, the operator API
   on an admin port, a memory audit sink, a ``file://`` state store and a
   watched directory. 15a ``bert_base_flash`` (an OAuth client added),
   ``bert_int8`` and ``iris`` POSTed to the operator API and warmed, each
   served through the gateway bit for bit as a standalone
   ``PredictorServer`` of the same file serves it, 12 flash launches a
   BERT request and 49 W8A16 launches a ``bert_int8`` forward by body, 0
   keys after warmup, per apply its seconds, ``memory_allocated()``
   growth, resident bytes and host estimate. 15b 16 users on
   ``bert-base-flash`` through the gateway while it is re-applied with
   seed 1 and ``mnist`` applied beside it: no request fails, every answer
   the old or the new version's (a standalone server of the seed-1 CR),
   the new one's from the first answer begun after apply returned, iris
   (4 users; p50 and p99 beside a window of the same traffic without an
   apply) and ``bert-int8`` unmoved; the old version unreachable though
   the serving GC policy froze it, the heap frozen again, and
   ``memory_allocated()`` (read with nothing thawed, less cuBLAS's
   per-stream workspaces, whose count over the phase is bounded by
   ``PLATFORM_NEW_WORKSPACES``) within ``PLATFORM_SLACK_BYTES`` of the
   bytes the resident parameters account for. 15e ``/profiler/start?duration_ms=``
   over three BERT requests writes a Chrome trace naming ``flash_fwd``;
   the native codec's counters show C head parses and a C ndarray parse
   of a body over 4096 bytes; iris's 1-user p50 and 16-user predictions/s
   with the codec and with it off in-process, in turns. 15c a budget the
   tenants fit and a second BERT-base does not: refused with "insufficient
   HBM", ``memory_allocated()`` exactly unchanged; deletes free their
   memory; the refused spec reconciles after a delete; after deleting
   everything the memory is back within the slack of its reading before
   15a. 15d an epsilon-greedy CR file in the watched directory serves,
   learns from three feedbacks, survives a torn rewrite, is re-applied
   with its arms restored from the state store, and is deleted when its
   file goes. Planted, each failing its check: an update whose new version
   answers with the old weights (on an iris copy), a delete that leaves a
   graph cache reachable, a delete that leaves the version frozen, a
   C-parsed head keeping the first of two ``Accept`` headers. The kernels
   line credits the platform's launches apart from its standalone twins'.
16. the tools (``serve_soak``, ``soak_legs``, ``serve_bundles``,
   ``lint_on_host``). 16a the spec ``tools/soak.py`` builds for
   ``--model 'bert_base?seq=512&attn_kernel=pallas'`` (BERT-base at full
   width, float32, TF32 off) on a standalone server: a 4-row answer, 12
   flash launches (the float32 body), held against blockwise attention
   and the kernel's plain version within ``F32_SERVE_ATOL``, three wrong
   attentions outside it; then ``soak()`` itself through the port's
   gateway stack in this process, 16 users x 4 rows for 20 s, with
   ``memory_allocated()`` sampled every 0.5 s after the soak's server
   warmed up: 0 errors, flash launches a positive multiple of 12, the
   soak's RSS slope net of the load generator and the device slope under
   their bounds; one shorter soak with a unit keeping a card-side clone of
   each batch's input and a path keeping each request body on the host
   must pass both bounds. 16a runs in a process of its own
   (``chip_smoke.py --soak``), fresh as the soak CLI's, since this
   script's heap after the earlier phases absorbs a host leak unseen.
   16b the soak CLI as processes with the
   ``Makefile``'s ``chaos-smoke`` and ``kvtier-smoke`` arguments (run
   together): 0 errors, an eviction and a recovery, demotions and
   promotions, 0 keys after warmup; ``--tp 2`` on one card (its positions
   are the host's cards) exits non-zero naming ``decode_mesh_axes``. 16c the install bundle's platform command
   (``build_bundle()``, no YAML) as a process, its three ports swapped
   for free ones and ``--watch-k8s`` for ``--watch-dir``: the rendered
   readiness probe and Prometheus scrape answer 200, and an ``iris`` CR
   applied through the admin port answers bit for bit what an in-process
   server of the same file answers. 16d ``torch_mnist_cnn`` wrapped by
   ``tools/wrap.py``, the rendered Dockerfile's CMD run from the bundle
   (at once with 16c), driven by ``tools/contract.py``, bit for bit the
   class in-process. 16e ``python -m seldon_core_tpu_torch.tools.lint``
   exits 0. Then phase 2's check and timing of the flash kernel at the
   float32 shape the soak served, at each bucket its batches reached.
17. the serving mesh (``serve_mesh``), on positions of the one card (the
   card count is printed beside them: no interconnect is exercised).
   17a ``bert_seq_parallel.json`` as the file has it (BERT-base, Ulysses,
   {"data": 2, "seq": 4}, bf16, buckets 8/16/32) served by a
   ``PredictorServer`` over 8 positions, then a float32 copy, the same with
   ``seq_parallel=ring``, and a ring copy at seq 512 (a 128-token block per
   position): each answer held against the same weights served unsharded
   on the card (bf16: within ``SERVE_ATOL``, argmax equal beyond a tie at
   that resolution; float32: ``MESH_F32_TOL``), 0 keys after warmup, the
   file's 1-user p50 and 16-user predictions/s beside the unsharded
   server's, parameter bytes and ``memory_allocated()`` growth of both.
   17b ``moe.json`` (8 positions) and ``pipeline_tower.json`` (4) applied
   as CRs on a ``Platform`` over the card's positions and answered through
   its gateway, held against the unsharded model at ``SMALL_MESH_TOL``,
   each position's parameter bytes. 17c ``bert_base_flash.json`` over
   {"model": 4}: Megatron tensor parallelism with each position's 3 heads
   through the flash kernel, 48 launches a forward (12 layers x 4
   positions, counted), held against the unsharded server; the kernel at
   (8, 3, 512, 512, 64) bf16 as QKV views against its plain version and
   timed as in phase 2. 17d the three files without positions asked for:
   the server and the platform's manager refuse each by the mesh rule.
18. tensor-parallel decode (``serve_tp``; ``parallel/tp.py``,
   ``tpu.decode_mesh_axes``) and int8 BERT over a "model" axis, on
   positions of the one card (no interconnect is exercised). 18a
   ``tiny_gpt_tensor_parallel.json`` as the file has it ({"tp": 2}) over
   two positions: every greedy row held under the tie rule against the
   same deployment at tp 1 and against the fused ``generate``, one SSE
   stream against its buffered reply, 0 keys after warmup, the shard audit
   and the allocator check, ``seldon_tpu_decode_kv_pages_per_device``
   labelled tp 2; without positions, one card serves it at tp 1 with the
   JAX package's "needs 2 devices, have 1" warning. 18b
   ``gpt2_small_speculative`` at full width over {"tp": 4} (chain, and a
   tree "2,2,1,1" copy) beside its tp-1 copy: 8 staggered greedy requests
   each, held under the tie rule, accept rate, rounds, ms per token and one
   round's device time and operations; a copy at seq 4096 with one request,
   whose draft admission must launch the causal flash kernel 8 times (2
   draft layers x 4 positions, counted), its ids held against tp 1; a
   planted fault (a row-parallel bias added on every position, on the
   target with nonzero biases) must fail the id check. 18c
   ``bert_base_flash.json`` with ``weight_quant: int8`` over {"model": 4}:
   answers within ``SERVE_ATOL`` of the unsharded int8 server's, 192 W8A16
   launches on the wgmma body plus the head's on mma and 48 flash launches
   per forward (counted), resident bytes and the 1-user p50 beside the
   unsharded server's (phase 7b holds the four shard shapes of its W8A16
   calls). 18d a 3 s ``soak(..., tp=2)`` over two positions, in a process
   of its own (``chip_smoke.py --tp-soak``): its shard audit and allocator
   check pass. Then the flash kernel at (1, 3, 4096,
   4096, 64) causal as QKV views against its plain version, timed as in
   phase 2.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the port beside it, it exits non-zero and prints no result.
TF32 is off for every matmul and convolution here (the plain versions and
the model's projections run in full float32 where they are float32).
"""

from __future__ import annotations

import asyncio
import contextlib
import faulthandler
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
# Kernel vs plain version, scaled to each case's output: the max abs error
# may reach ULPS ulps (in the dtype) of max|ref|, and ||out - ref|| / ||ref||
# may reach REL_L2. float32 sums in another order (measured: 2 ulps). bf16
# and f16 also round p per 128-key tile against the running max instead of
# once per row, which at most flips the rounding of an output element
# (measured: 1 ulp of max|ref| at every shape). A 5% error in the softmax
# normaliser or one dropped KV tile fails both limits; phase 2 shows that on
# every run.
KERNEL_TOL = {"float32": (64, 1e-5), "float16": (4, 1e-2), "bfloat16": (4, 1e-2)}
MANTISSA_BITS = {"float32": 23, "float16": 10, "bfloat16": 7}
# Served bf16 probabilities vs the same weights with blockwise attention, or
# with the kernel's plain version in its place: measured 0.0048 and 0.0050
# (ulp flips carried through 12 bf16 layers; the run is deterministic), while
# a uniform attention, a 5% normaliser error or one dropped 128-key KV tile
# moves them by 0.026 to 0.040 (chip_smoke.py on an H100, PERF.md). The limit sits
# between, and phase 3 checks on every run that the three stay outside it.
SERVE_ATOL = 1.5e-2
ROW_SUM_ATOL = 1e-3
SEQ_LONG = 4096  # the auto policy takes the kernel from PALLAS_MIN_SEQ
L2_FLUSH_BYTES = 128 << 20  # written before a cold-L2 call: over twice the 50 MB L2
KV_TILE = 128  # keys per KV tile of the bf16/f16 kernel
BASELINE_DIR = ROOT / "seldon_core_tpu_torch" / "deployments"
DEVICE = "cuda"  # where phases 4 and 5 serve
# Phase 4 limits (measured numbers: chip_smoke.py on an H100, PERF.md).
# Small models against the port's own forward on the CPU on the same
# weights: float32 sums 4 to 512 terms in another order (measured 1.2e-7);
# the bf16 MNIST deployment rounds each layer to bf16 on both sides, after
# sums taken in other orders (measured 2.2e-8; one flipped bf16 rounding of
# a logit could move a probability by a few 1e-3).
SMALL_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
AB_REQUESTS = 12
# The fused ensemble (members vmapped: grouped convolutions) against the same
# bf16 weights walked unfused (one convolution per member). Random-init
# ResNet50 logits reach 3e5, where one bf16 ulp is 2048: two top logits
# that tie in one path and not in the other move that member's probability
# by 0.5, the ensemble's by 1/6 (measured on some rows). So each row agrees
# within ENSEMBLE_ATOL, or differs by a tie: a multiple of 1/6 of a
# 3-member ensemble, in at most ENSEMBLE_TIE_ROWS of the rows.
ENSEMBLE_ATOL = 1e-2
ENSEMBLE_TIE_ROWS = 0.1
# Per member, logits (not probabilities: random-init ResNets saturate their
# softmax, so a probability check cannot see a padding fault): bf16 on the
# card against float32 on the card (measured 0.0046-0.0055; the JAX package
# 0.0046 on the CPU), and float32 on the card against float32 on the CPU
# (measured 4.5e-7). A stem padded (3, 3) or a max-pool padded (1, 1) moved
# them by 0.0110-0.0149 in bf16 and in float32: at least 2x the bf16 noise,
# so both faults must fail both checks.
RESNET_BF16_REL_L2 = 8e-3
RESNET_F32_REL_L2 = 1e-4
# Phase 5 limits (measured numbers: chip_smoke.py on an H100, PERF.md).
# Greedy ids of two paths (the card against the CPU, the scheduler against
# the fused generate, the kernel against blockwise attention) may part only
# at a near-tie: at the first diverging token the other path's top logit
# must be within GEN_TIE_MARGIN of its logit for the served token.
# No tie row showed in the first card run (32 GPT-2-small bf16 tokens
# against blockwise and the plain version; every float32 row equal).
GEN_TIE_MARGIN = {"float32": 1e-3, "bfloat16": 0.1}
# GPT-2-small prefill logits at every prompt position (the last row gives
# the first generated token), kernel against blockwise attention and against
# the plain version, relative L2: measured 0.0099-0.0124 (bf16 rounding
# through 12 layers), while a mask shifted by one key moved them by 0.076
# over the whole prompt (0.037 at the last row, whose own attention has no
# key past it to see) and a dropped 128-key tile by 0.32. The limit sits
# between, 2.4x above the noise and 2.5x below the shifted mask; both wrong
# attentions must land outside it over the whole prompt on every run.
LONG_LOGITS_REL_L2 = 0.03
INT8_KV_ATOL = 0.25  # the JAX package's own bound (tests/test_kv_pool.py)
CB_REQUESTS = 16
# Phase 6: requests per deployment, and the least mean number of draft
# tokens the GPT-2-small chain (k=4) must accept per riding slot and round
SPEC_REQUESTS = 16
SPEC_MIN_ACCEPTED = 1.0
# Phase 7: the W8A16 kernel against its plain version under KERNEL_TOL, as
# the flash kernel is held: bf16 rounds y once where the plain version rounds
# the product and then its sum with the bias (an ulp of y apart at most);
# every body forms the plain version's W bit for bit; float32 sums in
# another order. Scales applied per row instead of per column, or one K
# tile dropped, must fail every case (PERF.md has the measured margins). The bert_int8 deployment's
# probabilities against the same seed's bf16 deployment without weight_quant
# are held to the JAX package's own int8 bound (tests/test_quant.py:94);
# against the port's int8 forward on the CPU to SERVE_ATOL (bf16 rounding
# flips through 12 layers).
# K columns per tile: 64 for the wgmma and mma bodies (bf16), 32 for fma
INT8_K_TILE = {"bfloat16": 64, "float32": 32}
INT8_SERVE_ATOL = 3e-2
INT8_LAUNCHES = 12 * 4 + 1  # qkv, attn_out, mlp_in, mlp_out per layer, and the head
INT8_LAUNCHES_BY_BODY = {"wgmma": 12 * 4, "mma": 1, "fma": 0}  # the head has N = 2


def require_launches(label: str, deltas: list, want: int) -> None:
    """Launches per request on a served path, as the kernels' counters read
    them: on a captured path each replay credits the launches its capture
    counted, so 0 means the replays credit nothing, not that no kernel ran."""
    if any(d == 0 for d in deltas):
        raise AssertionError(f"{label}: a captured path reports 0 launches per request {deltas}: its graph replays "
                             f"credit no launches to the counter (want {want} each)")
    if deltas != [want] * len(deltas):
        raise AssertionError(f"{label}: launches per request {deltas}, want {want} each")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 25, warmup: int = 3, cold_l2: bool = False) -> float:
    """Median device time of one call, from CUDA events around the call. A
    device sleep ahead of each call keeps the queue full, so the events see
    only the call's own kernels, not the host's launch path. ``cold_l2``
    writes L2_FLUSH_BYTES between the sleep and the call, outside the
    events, so the call finds none of its inputs in L2."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def attention_bound(b, h, sq, sk, d, dtype_name, causal):
    """Least time for the call on an H100 SXM: each input read once and the
    output written once at HBM rate, against the multiply-adds the unmasked
    (row, key) pairs need at the dtype's peak."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = elem * b * h * d * (2 * sq + 2 * sk)
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    ops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def agreement(out, ref, dtype_name: str) -> dict:
    """How far ``out`` is from ``ref``, against the KERNEL_TOL limits scaled
    to this output: atol is ULPS ulps of max|ref| in the dtype."""
    import math

    import torch

    ulps, rel_limit = KERNEL_TOL[dtype_name]
    o, r = out.double(), ref.double()
    ref_max = r.abs().max().item()
    atol = ulps * 2.0 ** (math.floor(math.log2(max(ref_max, 1e-30))) - MANTISSA_BITS[dtype_name])
    max_abs = (o - r).abs().max().item()
    rel_l2 = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    ok = bool(torch.isfinite(out).all()) and max_abs <= atol and rel_l2 <= rel_limit
    return dict(max_abs_err=max_abs, atol=atol, rel_l2=rel_l2, rel_l2_limit=rel_limit, ok=ok)


def qkv_views(b, h, s, d, dtype, g):
    """q, k, v as models/bert.py cuts them from one fused QKV projection
    [b, s, 3*h*d]: [b, h, s, d] views, batch stride 3*h*d*s, head stride d,
    seq stride 3*h*d."""
    import torch

    fused = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))


def drop_kv_tile(k, v):
    """k, v without their second KV tile (KV_TILE keys, or half of a KV
    shorter than two tiles): what a kernel that skipped one stage of its
    ring would attend over."""
    import torch

    sk = k.shape[2]
    t = min(KV_TILE, sk // 2)
    keep = torch.cat([torch.arange(t), torch.arange(2 * t, sk)]).to(k.device)
    return k[:, :, keep].contiguous(), v[:, :, keep].contiguous()


def check_flash(case, card):
    """One kernel-vs-plain case on the card; returns its numbers. Two
    planted faults — the softmax normaliser 5% large, one KV tile dropped —
    must fail the same check, or the check is too loose for this case."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    name, (b, h, sq, sk, d), dtype, causal, layout = case
    g = torch.Generator(device="cuda").manual_seed(len(name) * 7919 + sq)
    if layout == "qkv_views":
        q, k, v = qkv_views(b, h, sq, d, dtype, g)
    else:
        q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    dtype_name = str(dtype).removeprefix("torch.")
    agree = agreement(out, ref, dtype_name)
    planted = {
        "l_x1.05": agreement((out.float() / 1.05).to(dtype), ref, dtype_name),
        "kv_tile_dropped": agreement(
            fa.flash_attention_reference(q, *drop_kv_tile(k, v), causal=causal), ref, dtype_name),
    }
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    ms_cold_l2 = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), cold_l2=True) if b == 8 else None
    plain_ms = device_ms(lambda: fa.flash_attention_reference(q, k, v, causal=causal))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    bound_ms, bound_by = attention_bound(b, h, sq, sk, d, dtype_name, causal)
    row = dict(
        case=name, shape=[b, h, sq, sk, d], dtype=dtype_name, causal=causal, layout=layout,
        max_abs_err=agree["max_abs_err"], atol=agree["atol"], rel_l2=agree["rel_l2"],
        rel_l2_limit=agree["rel_l2_limit"],
        planted_faults={k_: dict(max_abs_err=a["max_abs_err"], rel_l2=a["rel_l2"], caught=not a["ok"])
                        for k_, a in planted.items()},
        ms=ms, ms_cold_l2=ms_cold_l2, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by,
    )
    print(f"[{card}] flash_attention {json.dumps(row)}", flush=True)
    if not agree["ok"]:
        raise AssertionError(f"flash_attention {name}: kernel disagrees with its plain version: {agree}")
    for fault, a in planted.items():
        if a["ok"]:
            raise AssertionError(f"flash_attention {name}: the check passes a planted fault ({fault}): {a}")
    return row


async def _request(port: int, body: bytes, ctype: str = "application/json",
                   path: str = "/api/v0.1/predictions", headers: dict | None = None,
                   method: str = "POST") -> tuple[int, dict, bytes, float]:
    """One request through the port's REST ingress (a POST unless told):
    (status, lower-case headers, body, wall ms from connect to the last
    byte)."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items()).encode()
    writer.write(
        b"%s %s HTTP/1.1\r\nHost: localhost\r\nContent-Type: %s\r\nContent-Length: %d\r\n%s"
        b"Connection: close\r\n\r\n" % (method.encode(), path.encode(), ctype.encode(), len(body), extra) + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    ms = (time.perf_counter() - t0) * 1e3
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ", 2)[1]), headers, payload, ms


async def _post(port: int, body: bytes) -> tuple[int, dict, float]:
    status, _, payload, ms = await _request(port, body)
    return status, json.loads(payload), ms


def _model_runtime(server):
    return server.executor.root.unit.runtime


def _check_probs(out, n: int, classes: int = 2) -> "np.ndarray":
    """Served probabilities (a JSON response, or the array of an npy one):
    finite, [n, classes], every row summing to 1."""
    import numpy as np

    data = out["data"]["ndarray"] if isinstance(out, dict) else out
    probs = np.asarray(data, dtype=np.float64)
    if probs.shape != (n, classes) or not np.isfinite(probs).all():
        raise AssertionError(f"served probabilities have shape {probs.shape}, want ({n}, {classes})")
    worst = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if worst > ROW_SUM_ATOL:
        raise AssertionError(f"probability rows sum to 1 +- {worst} > {ROW_SUM_ATOL}")
    return probs


def plain_attention(q, k, v):
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return flash_attention_reference(q, k, v)


def wrong_attentions() -> dict:
    """Attentions that are wrong in ways a broken kernel could be: every key
    weighted alike, the softmax normaliser 5% large, one KV tile dropped."""
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return {
        "uniform": lambda q, k, v: v.mean(dim=2, keepdim=True).expand(q.shape),
        "l_x1.05": lambda q, k, v: flash_attention_reference(q, k, v) / 1.05,
        "kv_tile_dropped": lambda q, k, v: flash_attention_reference(q, *drop_kv_tile(k, v)),
    }


def check_served_bert(card, label: str, served, require_controls: bool = True) -> dict:
    """Served bf16 probabilities against the same weights run another way:
    with blockwise attention (no kernel) and with the kernel's plain version
    in its place, both within SERVE_ATOL; three wrong attentions on the same
    weights must land outside it. Float32 blockwise is a yardstick of the
    bf16 noise. ``served``: (runtime, ids, probabilities) per request.
    ``require_controls`` False prints the wrong attentions' distances
    without requiring them: how far a wrong attention moves the answers is
    a property of the weights, and phase 3's show the check's power."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.bert import apply_for_kernel, make_apply_bert
    from seldon_core_tpu_torch.models.convert import params_to_torch

    blockwise = apply_for_kernel("blockwise")
    plain = make_apply_bert(plain_attention)
    controls = {name: make_apply_bert(fn) for name, fn in wrong_attentions().items()}
    worst = dict.fromkeys(["blockwise", "plain_version", "blockwise_f32", *controls], 0.0)
    params32 = {}
    with torch.inference_mode():
        for runtime, ids, probs in served:
            if id(runtime) not in params32:
                params32[id(runtime)] = params_to_torch(runtime.params, runtime.device, torch.float32)
            x = torch.from_numpy(ids.astype(np.int32)).to(runtime.device)
            ref = blockwise(runtime.params, x).float().cpu().numpy()
            for name, (apply, params) in {"blockwise": (blockwise, runtime.params),
                                          "plain_version": (plain, runtime.params),
                                          "blockwise_f32": (blockwise, params32[id(runtime)])}.items():
                got = apply(params, x).float().cpu().numpy()
                worst[name] = max(worst[name], float(np.abs(probs - got).max()))
            for name, apply in controls.items():
                got = apply(runtime.params, x).float().cpu().numpy()
                worst[name] = max(worst[name], float(np.abs(got - ref).max()))
    del params32
    print(f"[{card}] {label} served vs blockwise: max_abs_diff={worst['blockwise']}; vs the kernel's plain "
          f"version: {worst['plain_version']} (atol {SERVE_ATOL} each); vs blockwise float32: "
          f"{worst['blockwise_f32']}", flush=True)
    need = f"each must exceed {SERVE_ATOL}" if require_controls else "information, not required on these weights"
    print(f"[{card}] {label} wrong attentions vs blockwise ({need}): "
          + " ".join(f"{name}={worst[name]}" for name in controls), flush=True)
    if max(worst["blockwise"], worst["plain_version"]) > SERVE_ATOL:
        raise AssertionError(f"{label}: served probabilities disagree with the same weights run another way: {worst}")
    for name in controls if require_controls else ():
        if worst[name] <= SERVE_ATOL:
            raise AssertionError(f"{label}: the serving check cannot see a wrong attention ({name}: {worst[name]})")
    return worst


async def serve_bert(card, deployment: Path):
    """Phase 3: BERT-base at seq 512 through REST, then the auto arm."""
    import numpy as np

    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, dep_name = load_predictor(str(deployment))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=dep_name, device="cuda")
    runtime = _model_runtime(server)
    t1 = time.perf_counter()
    server.warmup()
    t2 = time.perf_counter()
    layers = len(runtime.params["layers"])
    seq = runtime.feature_shape[0]
    vocab = runtime.params["tok_emb"].shape[0]
    print(f"[{card}] serve: {deployment.name} layers={layers} seq={seq} vocab={vocab} "
          f"dtype={runtime.dtype} buckets={runtime.buckets} build_s={t1 - t0:.3f} "
          f"warmup_s={t2 - t1:.3f} offload_compute={runtime.offload_compute} "
          f"warmup_forward_ms={runtime.stat_forward_ms}", flush=True)

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, vocab, size=(n, seq)) for n in (1, 8, 1, 8)]
    await server.start("127.0.0.1", 0)
    try:
        served, deltas, latencies = [], [], []
        LAUNCHES.reset()  # the main path's run starts here
        for ids in batches:
            before = LAUNCHES.count
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"predict returned HTTP {status}: {out}")
            served.append(_check_probs(out, len(ids)))
            deltas.append(LAUNCHES.count - before)
            latencies.append(ms)
        main_launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    for ids, ms, delta in zip(batches, latencies, deltas):
        print(f"[{card}] request batch={len(ids)} seq={seq} latency_ms={ms:.3f} kernel_launches={delta}", flush=True)
    require_launches("bert_base_flash flash_attention", deltas, layers)

    check_served_bert(card, "bert_base_flash", [(runtime, ids, probs) for ids, probs in zip(batches, served)])
    forward_breakdown(card, runtime, rng)

    # auto policy at long sequence: must take the kernel on the card
    auto_dep = {"spec": {"name": "bert-base-auto", "predictors": [{
        "name": "main",
        "graph": {"name": "bert", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model_uri", "value": f"zoo://bert_base?seq={SEQ_LONG}&max_len={SEQ_LONG}", "type": "STRING"}]},
        "tpu": {"max_batch": 1, "batch_buckets": [1], "dtype": "bfloat16"}}]}}
    auto_pred = default_deployment(SeldonDeployment.from_dict(auto_dep)).spec.predictors[0]
    long_server = PredictorServer(auto_pred, deployment_name="bert-base-auto", device="cuda")
    long_layers = len(_model_runtime(long_server).params["layers"])
    long_server.warmup()
    await long_server.start("127.0.0.1", 0)
    try:
        ids = rng.integers(0, vocab, size=(1, SEQ_LONG))
        LAUNCHES.reset()
        status, out, ms = await _post(long_server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
        auto_launches = LAUNCHES.count
    finally:
        await long_server.stop()
    if status != 200:
        raise AssertionError(f"auto predict returned HTTP {status}: {out}")
    _check_probs(out, 1)
    print(f"[{card}] request auto batch=1 seq={SEQ_LONG} latency_ms={ms:.3f} kernel_launches={auto_launches}", flush=True)
    require_launches(f"bert-base auto policy at seq {SEQ_LONG} flash_attention", [auto_launches], long_layers)
    return main_launches


def forward_breakdown(card, runtime, rng, reps: int = 3):
    """Where a served forward's time goes, per batch bucket: the host wall
    time of ``runtime.predict`` (ids in, probabilities back on the host),
    the device's busy time inside it as torch.profiler's CUDA activity sums
    it, the flash kernel's part of that, and the costliest kernels."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vocab, seq = runtime.params["tok_emb"].shape[0], runtime.feature_shape[0]
    for n in runtime.buckets:
        ids = rng.integers(0, vocab, size=(n, seq))
        runtime.predict(ids)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            runtime.predict(ids)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[len(walls) // 2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                runtime.predict(ids)
        kernels, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
                launches += e.count
        busy = sum(kernels.values())
        flash = sum(t for k, t in kernels.items() if "flash_fwd" in k)
        copies = sum(t for k, t in kernels.items() if "copy" in k.lower())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        if busy > 0:
            device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f} "
                      f"flash_ms={flash:.4f} flash_share_of_busy={flash / busy:.3f} copy_ms={copies:.4f}")
        else:
            device = "device time: not measured (the profiler saw no device activity)"
        print(f"[{card}] breakdown bucket={n} seq={seq} predict_wall_ms={wall:.3f} "
              f"device_ops_per_forward={launches / reps:g} {device}", flush=True)
        for name, t in top:
            print(f"    {t:.4f} ms  {name[:110]}")


def profile_device(fn, reps: int = 3) -> tuple[dict, float]:
    """Device time per call of each kernel ``fn`` runs (torch.profiler's CUDA
    activity, averaged over ``reps`` calls) and device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
            launches += e.count
    return kernels, launches / reps


def wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` (which must end on the host)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


async def _start(path: Path, cuda_graphs: bool = True, **server_kw):
    """A warmed PredictorServer for one deployment file, serving REST on a
    free port on the card; returns it with its build and warmup seconds.
    ``cuda_graphs=False`` builds the eager twin; ``server_kw`` goes to the
    server (``metrics_enabled=False``). The server's
    ``warmup_reserved_bytes`` is the growth of torch.cuda.memory_reserved()
    over its warmup (from an emptied cache): on the captured server, the
    graph pool."""
    import torch

    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, name = load_predictor(str(path))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=name, device=DEVICE, cuda_graphs=cuda_graphs, **server_kw)
    t1 = time.perf_counter()
    on_card = DEVICE == "cuda"
    if on_card:
        torch.cuda.synchronize()
        gc.collect()  # earlier servers' graphs and buffers leave the cache first
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
    server.warmup()
    if on_card:
        torch.cuda.synchronize()
    server.warmup_reserved_bytes = torch.cuda.memory_reserved() - reserved if on_card else 0
    t2 = time.perf_counter()
    await server.start("127.0.0.1", 0)
    return server, t1 - t0, t2 - t1


def cpu_forward(runtime, x, cache: dict) -> "np.ndarray":
    """The runtime's own apply on the CPU, on the weights it holds on the
    card (copied over in their dtype)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch

    if id(runtime) not in cache:
        cache[id(runtime)] = params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)
    with torch.inference_mode():
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(runtime.dtype)
        return runtime.apply_fn(cache[id(runtime)], xt).float().numpy()


async def serve_small(card) -> None:
    """Phase 4a: iris, MNIST and the iris A/B test as JSON, each answer held
    against the port's own forward on the CPU; the A/B test's routing
    against the sequence random.Random(1337) gives."""
    import random

    import numpy as np

    rng = np.random.default_rng(1)
    cases = (("iris", 4, 8.0, (1, 4, 1)), ("mnist", 784, 1.0, (1, 4, 1)),
             ("iris_abtest", 4, 8.0, (1,) * AB_REQUESTS))
    for name, features, scale, sizes in cases:
        server, build_s, warmup_s = await _start(BASELINE_DIR / f"{name}.json")
        try:
            results = []
            for n in sizes:
                x = rng.uniform(0, scale, size=(n, features)).round(2)
                status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": x.tolist()}}).encode())
                if status != 200:
                    raise AssertionError(f"{name} predict returned HTTP {status}: {out}")
                results.append((x, out, ms))
        finally:
            await server.stop()
        root = server.executor.root
        routes = [out["meta"].get("routing", {}).get(root.name) for _, out, _ in results]
        cache, worst, dtype = {}, 0.0, None
        for (x, out, _), route in zip(results, routes):
            runtime = (root if route is None else root.children[route]).unit.runtime
            dtype = str(runtime.dtype).removeprefix("torch.")
            probs = _check_probs(out, len(x), len(runtime.class_names))
            worst = max(worst, float(np.abs(probs - cpu_forward(runtime, x, cache)).max()))
        lat = " ".join(f"{ms:.3f}" for _, _, ms in results)
        print(f"[{card}] {name}: dtype={dtype} build_s={build_s:.3f} warmup_s={warmup_s:.3f} "
              f"request_ms=[{lat}] vs the CPU forward: max_abs_diff={worst} (atol {SMALL_ATOL[dtype]})", flush=True)
        if worst > SMALL_ATOL[dtype]:
            raise AssertionError(f"{name}: served probabilities disagree with the CPU forward by {worst}")
        if name == "iris_abtest":
            draws = random.Random(1337)
            want = [0 if draws.random() < root.unit.ratio_a else 1 for _ in routes]
            print(f"[{card}] iris_abtest routing {routes}", flush=True)
            if routes != want:
                raise AssertionError(f"A/B routing {routes}, random.Random(1337) gives {want}")


FORM_BOUNDARY = "chipsmokeform"


async def serve_engine_compat(card) -> dict:
    """Phase 4: the reference's engine surface on the served iris. /pause
    then /ready answers 503 ``paused``, /unpause then /ready 200 ``ready``,
    by GET and by POST; a prediction sent as an urlencoded and as a
    multipart ``json=`` form answers what its JSON body answers, bit for
    bit; a form without the field answers 400 with code 101; and
    ``load_predictor`` refuses a copy of iris_abtest whose ROUTER has no
    children, with the reference's problem text."""
    from urllib.parse import urlencode

    import numpy as np

    from seldon_core_tpu_torch.graph.validation import ValidationError
    from seldon_core_tpu_torch.serving.server import load_predictor

    x = np.random.default_rng(2).uniform(0, 8, size=(4, 4)).round(2)
    msg = json.dumps({"data": {"ndarray": x.tolist()}})
    forms = {
        "urlencoded": (urlencode({"json": msg}).encode(), "application/x-www-form-urlencoded"),
        "multipart": (f'--{FORM_BOUNDARY}\r\nContent-Disposition: form-data; name="json"\r\n\r\n{msg}\r\n'
                      f"--{FORM_BOUNDARY}--\r\n".encode(), f"multipart/form-data; boundary={FORM_BOUNDARY}"),
    }
    want = [("/pause", 200, "paused"), ("/ready", 503, "paused"), ("/unpause", 200, "unpaused"), ("/ready", 200, "ready")]
    server, *_ = await _start(BASELINE_DIR / "iris.json")
    try:
        readiness = {}
        for method in ("GET", "POST"):
            readiness[method] = []
            for path, *_ in want:
                status, _, body, _ = await _request(server.port, b"", path=path,
                                                    method="GET" if path == "/ready" else method)
                readiness[method].append((path, status, body.decode()))
            if readiness[method] != want:
                raise AssertionError(f"/pause and /unpause by {method}: {readiness[method]}, want {want}")
        status, _, body, _ = await _request(server.port, msg.encode())
        ref = json.loads(body)["data"]["ndarray"]
        for name, (form, ctype) in forms.items():
            status, _, body, _ = await _request(server.port, form, ctype)
            if status != 200 or json.loads(body)["data"]["ndarray"] != ref:
                raise AssertionError(f"a {name} json= prediction answered {status}: {body[:300]!r}, not the JSON "
                                     "body's answer")
        status, _, body, _ = await _request(server.port, urlencode({"payload": msg}).encode(),
                                            "application/x-www-form-urlencoded")
        err = json.loads(body)
        if status != 400 or err.get("code") != 101 or err.get("info") != "missing 'json' form field":
            raise AssertionError(f"a form without json= answered {status}: {err}")
    finally:
        await server.stop()
    dep = json.loads((BASELINE_DIR / "iris_abtest.json").read_text())
    dep["spec"]["predictors"][0]["graph"]["children"] = []
    path = ROOT / "build" / "iris_abtest_childless_router.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    try:
        load_predictor(str(path))
    except ValidationError as e:
        problems = e.problems
    else:
        raise AssertionError("load_predictor served an A/B router with no children")
    if "ROUTER 'ab' must have children" not in problems:
        raise AssertionError(f"the childless router was refused without the reference's text: {problems}")
    out = {"readiness": readiness, "forms": sorted(forms), "missing_field": err, "childless_router": problems}
    print(f"[{card}] engine compat (iris): {json.dumps(out)}", flush=True)
    return out


def _member_params(predictor, dtype, device):
    """Each ensemble member's parameters, from its zoo URI, in ``dtype``."""
    from seldon_core_tpu_torch.graph.spec import parameters_dict
    from seldon_core_tpu_torch.models import zoo
    from seldon_core_tpu_torch.models.convert import params_to_torch

    out = []
    for child in predictor.graph.children:
        name, kwargs = zoo._parse_zoo_uri(parameters_dict(child.parameters)["model_uri"])
        ms = zoo.get_model(name, **kwargs)
        out.append(params_to_torch(ms.params, device, dtype, ms.layout))
    return out


class planted:
    """Replace one function of a module for the duration of a ``with``."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def resnet_padding_faults() -> dict:
    """The two shape-preserving padding faults of a port of XLA's SAME:
    the 7x7/2 stem padded (3, 3), the 3x3/2 max-pool padded (1, 1)."""
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models import resnet

    same = resnet._same_pads
    return {
        "stem_3_3": planted(resnet, "_same_pads", lambda n, k, s: (3, 3) if k == 7 else same(n, k, s)),
        "max_pool_1_1": planted(resnet, "_max_pool_same", lambda h: F.max_pool2d(h, 3, 2, padding=1)),
    }


def check_resnet_logits(card, predictor, image) -> dict:
    """Per member: bf16 logits on the card against float32 logits on the
    card (TF32 off), and float32 logits on the card against float32 logits
    on the CPU; the two planted padding faults must fail both checks."""
    import torch

    from seldon_core_tpu_torch.models import resnet

    cuda, cpu = torch.device(DEVICE), torch.device("cpu")
    x = torch.from_numpy(image).to(cuda)
    rows = []
    with torch.inference_mode():
        for i, (p16, p32, pcpu) in enumerate(zip(_member_params(predictor, torch.bfloat16, cuda),
                                                 _member_params(predictor, torch.float32, cuda),
                                                 _member_params(predictor, torch.float32, cpu))):
            l32 = resnet.resnet_logits(p32, x.float()).cpu()
            row = {"member": i, "max_abs_logit": float(l32.abs().max()),
                   "bf16_vs_f32": rel_l2(resnet.resnet_logits(p16, x.to(torch.bfloat16)).float().cpu(), l32)}
            lcpu = resnet.resnet_logits(pcpu, x.cpu().float())
            row["f32_vs_cpu"] = rel_l2(l32, lcpu)
            for fault, ctx in resnet_padding_faults().items():
                with ctx:
                    row[f"{fault}_bf16"] = rel_l2(resnet.resnet_logits(p16, x.to(torch.bfloat16)).float().cpu(), l32)
                    row[f"{fault}_f32"] = rel_l2(resnet.resnet_logits(p32, x.float()).cpu(), lcpu)
            rows.append(row)
            print(f"[{card}] resnet50 member logits (relative L2): {json.dumps(row)}", flush=True)
    for row in rows:
        if row["bf16_vs_f32"] > RESNET_BF16_REL_L2 or row["f32_vs_cpu"] > RESNET_F32_REL_L2:
            raise AssertionError(f"resnet50 member logits disagree: {row}")
        for fault in resnet_padding_faults():
            if row[f"{fault}_bf16"] <= RESNET_BF16_REL_L2 or row[f"{fault}_f32"] <= RESNET_F32_REL_L2:
                raise AssertionError(f"the resnet logits check passes a planted fault ({fault}): {row}")
    return rows


def serve_resnet_ensemble(card) -> None:
    """Phase 4b: the 3x ResNet50 average ensemble as one FusedUnit, fed uint8
    npy bodies at batch 1 and 128, answered in npy; the answers against the
    same bf16 weights walked unfused; each member's logits checked; fused,
    sequential and unfused forwards timed."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from seldon_core_tpu_torch.core.message import SeldonMessage
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.engine.fused import FusedUnit
    from seldon_core_tpu_torch.models.resnet import apply_resnet

    loop = asyncio.new_event_loop()
    try:
        server, build_s, warmup_s = loop.run_until_complete(_start(BASELINE_DIR / "resnet_ensemble.json"))
        try:
            fused = server.executor.root.unit
            if not isinstance(fused, FusedUnit) or server.executor.root.children:
                raise AssertionError(f"the ensemble's root is {type(fused).__name__}, not one FusedUnit")
            runtime = fused.runtime
            print(f"[{card}] resnet_ensemble: root {fused.image} dtype={runtime.dtype} buckets={runtime.buckets} "
                  f"build_s={build_s:.3f} warmup_s={warmup_s:.3f} offload_compute={runtime.offload_compute}",
                  flush=True)
            rng = np.random.default_rng(3)
            shape, classes = runtime.feature_shape, len(runtime.class_names)
            images = {n: rng.integers(0, 256, size=(n, *shape), dtype=np.uint8) for n in (1, max(runtime.buckets))}
            served = {}
            for n, x in list(images.items()) * 2:
                buf = io.BytesIO()
                np.save(buf, x)
                status, headers, body, ms = loop.run_until_complete(
                    _request(server.port, buf.getvalue(), "application/x-npy"))
                if status != 200 or headers.get("content-type") != "application/x-npy":
                    raise AssertionError(f"npy predict returned HTTP {status} {headers}: {body[:200]!r}")
                served[n] = _check_probs(np.load(io.BytesIO(body)), n, classes)
                print(f"[{card}] request resnet_ensemble npy uint8 batch={n} body_bytes={len(buf.getvalue())} "
                      f"latency_ms={ms:.3f} seldon_meta={headers.get('seldon-meta')}", flush=True)
        finally:
            loop.run_until_complete(server.stop())

        predictor = server.predictor
        unfused_spec = dataclasses.replace(predictor, tpu=dataclasses.replace(predictor.tpu, fuse_graph=False))
        unfused = build_executor(unfused_spec, context={"device": torch.device(DEVICE)})
        for node in unfused.root.walk():
            if getattr(node.unit, "runtime", None) is not None:
                node.unit.runtime.warmup()

        def walk_unfused(x):
            return np.asarray(loop.run_until_complete(unfused.execute(SeldonMessage.from_array(x))).array)

        gaps = np.concatenate([np.abs(served[n] - walk_unfused(x)).max(axis=1) for n, x in images.items()])
        ties = gaps > ENSEMBLE_ATOL
        tie_steps = gaps[ties] * 6  # a tie in one member moves a 3-member mean by 1/6
        print(f"[{card}] resnet_ensemble fused vs unfused (same bf16 weights): rows={len(gaps)} "
              f"within {ENSEMBLE_ATOL}: {int((~ties).sum())}, max_abs_diff of those={float(gaps[~ties].max(initial=0.0))}; "
              f"bf16 logit ties: {int(ties.sum())} rows, diffs {sorted(float(g) for g in gaps[ties])}", flush=True)
        if ties.mean() > ENSEMBLE_TIE_ROWS or np.abs(tie_steps - np.round(tie_steps)).max(initial=0) > 6 * ENSEMBLE_ATOL:
            raise AssertionError(f"the fused ensemble disagrees with the unfused walk: {sorted(gaps[ties])}")
        check_resnet_logits(card, predictor, images[1])

        members = [_unstack(runtime.params["members"], i) for i in range(len(predictor.graph.children))]

        def sequential(x):
            with torch.inference_mode():
                y = torch.stack([apply_resnet(m, x.to(runtime.dtype)) for m in members]).mean(dim=0)
            return y

        for n, x in images.items():
            xdev = torch.from_numpy(x).to(DEVICE)
            rows = {
                "fused_vmap": lambda: runtime.predict(x),
                "fused_sequential": lambda: sequential(xdev).cpu(),
                "unfused_walk": lambda: walk_unfused(x),
            }
            for label, host_fn in rows.items():
                wall = wall_ms(host_fn)
                kernels, ops = profile_device(host_fn)
                busy = sum(kernels.values())
                top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
                device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f}" if busy > 0
                          else "device time: not measured (the profiler saw no device activity)")
                print(f"[{card}] resnet_ensemble breakdown bucket={n} {label} wall_ms={wall:.3f} "
                      f"device_ops_per_forward={ops:g} {device}", flush=True)
                for name, t in top:
                    print(f"    {t:.4f} ms  {name[:110]}")
    finally:
        loop.close()


def _unstack(tree, i):
    """Member ``i`` of a tree stacked on a leading ensemble axis."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unstack(v, i) for v in tree)
    return tree[i]


async def serve_dag(card) -> int:
    """Phase 4c: transformer -> epsilon-greedy -> 2x BERT-base (seq 128,
    attn_kernel=pallas) as JSON ids. The flash kernel must launch 12 times
    per request; the answers are held against blockwise attention on the
    routed arm's weights; one feedback of reward 1 must move only the routed
    arm's counts and rewards. Returns the kernel launches of the path."""
    import numpy as np

    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    server, build_s, warmup_s = await _start(BASELINE_DIR / "full_dag_bert.json")
    router_node = server.executor.root.children[0]
    router = router_node.unit
    arms = [c.unit.runtime for c in router_node.children]
    seq, vocab = arms[0].feature_shape[0], arms[0].params["tok_emb"].shape[0]
    layers = len(arms[0].params["layers"])
    print(f"[{card}] full_dag_bert: {server.executor.root.name} -> {router_node.name} -> "
          f"{[c.name for c in router_node.children]} seq={seq} layers={layers} dtype={arms[0].dtype} "
          f"buckets={arms[0].buckets} build_s={build_s:.3f} warmup_s={warmup_s:.3f}", flush=True)
    rng = np.random.default_rng(4)
    try:
        served, deltas, latencies, responses = [], [], [], []

        async def ask(ids):
            before = LAUNCHES.count
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"DAG predict returned HTTP {status}: {out}")
            route = out["meta"]["routing"][router_node.name]
            served.append((arms[route], ids, _check_probs(out, len(ids))))
            deltas.append(LAUNCHES.count - before)
            latencies.append((len(ids), route, ms))
            responses.append(out)

        LAUNCHES.reset()  # the path's run starts here
        for n in (1, 8, 1, 64, 1):
            await ask(rng.integers(0, vocab, size=(n, seq)))
        route = responses[0]["meta"]["routing"][router_node.name]
        counts, rewards = list(router.counts), list(router.rewards)
        fb = json.dumps({"response": responses[0], "reward": 1.0}).encode()
        status, _, body, _ = await _request(server.port, fb, path="/api/v0.1/feedback")
        if status != 200:
            raise AssertionError(f"feedback returned HTTP {status}: {body[:200]!r}")
        want_counts = [c + (i == route) for i, c in enumerate(counts)]
        want_rewards = [r + (1.0 if i == route else 0.0) for i, r in enumerate(rewards)]
        print(f"[{card}] feedback reward=1 on arm {route}: counts {counts} -> {router.counts}, "
              f"rewards {rewards} -> {router.rewards}", flush=True)
        if router.counts != want_counts or router.rewards != want_rewards:
            raise AssertionError(f"feedback moved the router to {router.counts} {router.rewards}, "
                                 f"want {want_counts} {want_rewards}")
        for n in (1, 8):
            await ask(rng.integers(0, vocab, size=(n, seq)))
        launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    for (n, route, ms), delta in zip(latencies, deltas):
        print(f"[{card}] request full_dag_bert batch={n} seq={seq} arm={route} latency_ms={ms:.3f} "
              f"kernel_launches={delta}", flush=True)
    require_launches("full_dag_bert flash_attention", deltas, layers)
    check_served_bert(card, "full_dag_bert", served)
    return launches


def _ids_post(port: int, ids, tags: dict | None = None, path: str = "/api/v0.1/predictions"):
    body = {"data": {"ndarray": ids.tolist()}}
    if tags:
        body["meta"] = {"tags": tags}
    return _request(port, json.dumps(body).encode(), path=path)


def next_logits(params, seq) -> "torch.Tensor":
    """Float32 next-token logits after ``seq`` (one prefill forward)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import prefill

    with torch.inference_mode():
        return prefill(params, torch.from_numpy(np.asarray(seq, np.int64)[None]))[0][0].float()


def tie_rule(label, served, ref, params, prompt_len: int, dtype_name: str) -> list:
    """Rows of ``served`` against ``ref`` (int arrays, prompt included):
    equal, or parting first at a near-tie of the reference path, whose
    parameters are ``params`` (its attention as currently planted). Returns
    the tie rows as (row, generated index, gap)."""
    import numpy as np

    margin = GEN_TIE_MARGIN[dtype_name]
    ties = []
    for r, (a, b) in enumerate(zip(np.asarray(served), np.asarray(ref))):
        n = min(len(a), len(b))
        diff = np.nonzero(a[prompt_len:n] != b[prompt_len:n])[0]
        if not len(diff):
            continue
        t = prompt_len + int(diff[0])
        logits = next_logits(params, a[:t].astype(np.int64)).cpu()
        gap = float(logits.max() - logits[int(a[t])])
        ties.append((r, t - prompt_len, gap))
        if gap > margin:
            raise AssertionError(f"{label}: row {r} parts from the reference at generated token {t - prompt_len} "
                                 f"({a[t]} vs {b[t]}) with a top-logit gap of {gap} > {margin}")
    return ties


def _cpu_params(runtime):
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch

    return params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)


async def serve_tiny_gpt(card) -> None:
    """Phase 5a: the fused greedy generate through REST at buckets 2 and 8
    (float32), held against the port's own generate and reference_generate
    on the CPU on the same weights."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import generate, reference_generate

    server, build_s, warmup_s = await _start(BASELINE_DIR / "tiny_gpt.json")
    runtime = _model_runtime(server)
    seq, max_new = runtime.generative["seq"], runtime.generative["max_new_tokens"]
    vocab = runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(5)
    try:
        served = []
        for n in (2, 8):
            ids = rng.integers(0, vocab, size=(n, seq))
            status, _, body, ms = await _ids_post(server.port, ids)
            if status != 200:
                raise AssertionError(f"tiny_gpt predict returned HTTP {status}: {body[:300]!r}")
            out = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)
            if out.shape != (n, seq + max_new) or not (out[:, :seq] == ids).all():
                raise AssertionError(f"tiny_gpt served ids of shape {out.shape}, want ({n}, {seq + max_new}) "
                                     "with the prompt echoed")
            served.append((ids, out, ms))
    finally:
        await server.stop()
    cpu = _cpu_params(runtime)
    ties = []
    for ids, out, ms in served:
        with torch.inference_mode():
            want = generate(cpu, torch.from_numpy(ids), max_new).numpy()
        ref = reference_generate(cpu, ids, max_new)
        if not (ref == want).all():
            raise AssertionError("tiny_gpt: the CPU generate disagrees with reference_generate")
        ties += tie_rule("tiny_gpt", out, want, cpu, seq, "float32")
        print(f"[{card}] request tiny_gpt batch={len(ids)} latency_ms={ms:.3f} rows equal to the CPU "
              f"forward: {int((out == want).all(axis=1).sum())}/{len(ids)}", flush=True)
    print(f"[{card}] tiny_gpt: build_s={build_s:.3f} warmup_s={warmup_s:.3f} tie rows {ties} "
          f"(margin {GEN_TIE_MARGIN['float32']})", flush=True)


def _fused_oracle(runtime, ids):
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import generate

    with torch.inference_mode():
        return generate(runtime.params, torch.from_numpy(np.asarray(ids)).to(runtime.device),
                        runtime.generative["max_new_tokens"]).cpu().numpy()


def _deployment_copy(name: str, tpu_update: dict, graph_update: dict | None = None) -> Path:
    """A copy of a deployment file with its tpu block (and its graph's
    parameter values) updated, under the git-ignored build/."""
    dep = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    pred = dep["spec"]["predictors"][0]
    pred["tpu"].update(tpu_update)
    for p in pred["graph"]["parameters"]:
        p["value"] = (graph_update or {}).get(p["name"], p["value"])
    path = ROOT / "build" / f"{name}_{'_'.join([*tpu_update, *(graph_update or {})])}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


async def _read_sse(port: int, ids) -> tuple[int, list]:
    """One POST to the SSE route: (status, the data events in order)."""
    status, headers, body, _ = await _ids_post(port, ids, path="/api/v0.1/predictions/stream")
    if status != 200 or headers.get("transfer-encoding") != "chunked":
        raise AssertionError(f"stream returned HTTP {status} {headers}: {body[:300]!r}")
    raw, rest = b"", body
    while True:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            break
        raw, rest = raw + rest[:size], rest[size + 2:]
    return status, [json.loads(f[6:]) for f in raw.split(b"\n\n") if f.startswith(b"data: ")]


async def serve_continuous_batching(card) -> None:
    """Phase 5b: gpt_continuous_batching under 16 staggered requests with
    mixed per-request max_new_tokens, every row against the fused generate
    on the card; one SSE stream against its buffered reply; no new dispatch
    key after warmup; an EOS copy of the deployment retiring early; the
    per-step device time and host share."""
    import numpy as np

    path = BASELINE_DIR / "gpt_continuous_batching.json"
    server, build_s, warmup_s = await _start(path)
    twin, _, twin_warm = await _start(path, cuda_graphs=False)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, vocab, size=(CB_REQUESTS, seq))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=CB_REQUESTS)]

    async def traffic(port):
        async def one(i):
            await asyncio.sleep(0.004 * i)  # staggered arrival: later rows admit mid-stream
            return await _ids_post(port, prompts[i : i + 1], {"max_new_tokens": budgets[i]})

        t0 = time.perf_counter()
        replies = await asyncio.gather(*(one(i) for i in range(CB_REQUESTS)))
        return replies, time.perf_counter() - t0

    try:
        replies, wall = await traffic(server.port)
        twin_replies, twin_wall = await traffic(twin.port)
        status, events = await _read_sse(server.port, prompts[:1])
        _, _, body, _ = await _ids_post(server.port, prompts[:1])
        buffered = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        recompiles = (sched.recompiles_since_warmup(), twin.decode_scheduler.recompiles_since_warmup())
        steps, peak = sched.stat_steps, sched.stat_peak_active
    finally:
        await server.stop()
        await twin.stop()
    served = _served_rows("gpt_continuous_batching", replies, budgets, seq)
    twin_rows = _served_rows("gpt_continuous_batching eager twin", twin_replies, budgets, seq)
    hold_twin_rows("gpt_continuous_batching", served, twin_rows)
    want = _fused_oracle(runtime, prompts)
    ties = []
    for r, (out, b) in enumerate(zip(served, budgets)):
        ties += [(r, *t[1:]) for t in tie_rule("gpt_continuous_batching", [out], [want[r][: seq + b]],
                                               runtime.params, seq, "float32")]
    lat = sorted(ms for _, _, _, ms in replies)
    tokens = [e["token"] for e in events if "token" in e]
    done = events[-1]
    print(f"[{card}] gpt_continuous_batching: slots={sched.n_slots} build_s={build_s:.3f} warmup_s={warmup_s:.3f} "
          f"requests={CB_REQUESTS} tokens={sum(budgets)} wall_s={wall:.3f} steps={steps} peak_active={peak} "
          f"latency_ms p50={lat[len(lat) // 2]:.3f} max={lat[-1]:.3f} rows equal to the fused generate: "
          f"{sum(int((o == w[: len(o)]).all()) for o, w in zip(served, want))}/{CB_REQUESTS} tie rows {ties} "
          f"recompiles_since_warmup (captured, eager)={recompiles}; eager twin wall_s={twin_wall:.3f} "
          f"warmup_s={twin_warm:.3f}; compile_counts {sched.compile_counts()} captures={sched.graphs.stat_captures}; "
          f"warmup memory_reserved growth bytes captured={server.warmup_reserved_bytes} "
          f"eager={twin.warmup_reserved_bytes}", flush=True)
    print(f"[{card}] gpt_continuous_batching stream: {len(tokens)} token events, done={done.get('done')} "
          f"gen_lens={done.get('gen_lens')}", flush=True)
    if recompiles != (0, 0):
        raise AssertionError(f"the schedulers (captured, eager) built {recompiles} new keys after warmup")
    if tokens != buffered[seq:].tolist() or done.get("ids") != [buffered.tolist()]:
        raise AssertionError("the SSE stream's tokens differ from the buffered reply for the same prompt")
    step_breakdown(card, {"captured": sched, "eager": twin.decode_scheduler})

    # EOS: a copy of the deployment whose eos id is the 3rd greedy token of
    # a prompt must stop that row there
    eos = int(want[1][seq + 2])
    server, _, _ = await _start(_deployment_copy("gpt_continuous_batching", {"decode_eos_id": eos}))
    try:
        status, _, body, ms = await _ids_post(server.port, prompts[1:2])
    finally:
        await server.stop()
    out = json.loads(body)
    gen_len = out["meta"]["tags"]["gen_lens"][0]
    cut = seq + want[1][seq:].tolist().index(eos) + 1
    print(f"[{card}] gpt_continuous_batching eos={eos}: gen_lens={gen_len} latency_ms={ms:.3f}", flush=True)
    row = np.asarray(out["data"]["ndarray"], np.int64)[0]
    if status != 200 or gen_len != cut - seq or not (row[:cut] == want[1][:cut]).all() or not (row[cut:] == eos).all():
        raise AssertionError(f"the EOS deployment did not retire the row at its first eos: {body[:300]!r}")


def hold_twin_rows(label: str, rows, twin_rows) -> None:
    """Greedy ids of the captured scheduler against its eager twin's: bit for
    bit (the same kernels, launch configurations and order run either
    way)."""
    differ = [r for r, (a, b) in enumerate(zip(rows, twin_rows)) if a.shape != b.shape or (a != b).any()]
    if differ:
        raise AssertionError(f"{label}: captured rows {differ} differ from the eager twin's")


def step_breakdown(card, scheds: dict, reps: int = 20) -> None:
    """One scheduler step per mode with every slot generating (all-zero
    block tables: every write lands in junk page 0): host wall time (the
    step ends in the token readback), device busy time, host share."""
    import numpy as np

    fns = {}
    for mode, sched in scheds.items():
        n = sched.n_slots
        z, pos = np.zeros(n, np.int32), np.full(n, sched.max_ctx - 1, np.int32)
        bt, zf = sched.pool.block_tables(), np.zeros(n, np.float32)

        def step(sched=sched, z=z, pos=pos, bt=bt, zf=zf):
            sched.pool.load_block_tables(bt)
            sched._step(z, pos, zf, z, 0)

        fns[mode] = step
    any_sched = next(iter(scheds.values()))
    _modes_breakdown(card, f"decode step breakdown slots={any_sched.n_slots} "
                     f"virtual_ctx={any_sched.pool.virtual_ctx}", fns, "step", reps)


async def serve_paged_kv(card) -> None:
    """Phase 5c: tiny_gpt_paged_kv (int8 pages, prefix reuse, chunked
    prefill) under shared-prefix traffic: the prefix index must hit, the
    allocator's audit must hold, and int8 against fp pools on the same
    weights, teacher-forced, must stay within INT8_KV_ATOL."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import decoder

    path = BASELINE_DIR / "tiny_gpt_paged_kv.json"
    server, build_s, warmup_s = await _start(path)
    twin, _, _ = await _start(path, cuda_graphs=False)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, vocab, size=(12, seq))
    prompts[:, : seq - 16] = prompts[0, : seq - 16]  # one shared system prompt

    async def traffic(port):
        first = await _ids_post(port, prompts[:1], {"cache_prefix": seq - 16})
        rest = await asyncio.gather(*(_ids_post(port, prompts[i : i + 1]) for i in range(1, 12)))
        out = []
        for status, _, body, _ in [first, *rest]:
            if status != 200:
                raise AssertionError(f"tiny_gpt_paged_kv returned HTTP {status}: {body[:300]!r}")
            out.append(np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0])
        return out

    try:
        served = await traffic(server.port)
        hold_twin_rows("tiny_gpt_paged_kv", served, await traffic(twin.port))
        stats = dict(hits=sched.stat_prefix_hits, misses=sched.stat_prefix_misses,
                     tokens_saved=sched.stat_prefix_tokens_saved, chunks=sched.stat_chunk_dispatches,
                     cow=sched.pool.alloc.stat_cow_copies, shared=sched.pool.alloc.stat_pages_shared,
                     recompiles=sched.recompiles_since_warmup(),
                     twin_recompiles=twin.decode_scheduler.recompiles_since_warmup(),
                     compile_counts=sched.compile_counts(), captures=sched.graphs.stat_captures,
                     pool_bytes=server.warmup_reserved_bytes)
        sched.pool.alloc.check()
    finally:
        await server.stop()
        await twin.stop()
    want = _fused_oracle(runtime, prompts)
    agree = float(np.mean([(s[seq:] == w[seq:]).mean() for s, w in zip(served, want)]))

    # teacher-forced int8 against fp pools on the deployment's weights
    params, pool = runtime.params, sched.pool
    pps = pool.pages_per_slot
    bt = torch.arange(1, 1 + pps, device=runtime.device)[None, :]
    on = lambda a: torch.as_tensor(a, device=runtime.device)  # noqa: E731
    streams = {}
    with torch.inference_mode():
        pools = {kv: decoder.paged_kv_init(params, 1 + pps, pool.page_size, kv_dtype=kv) for kv in ("", "int8")}
        for kv, p in pools.items():
            lg, _, _ = decoder.paged_chunk_prefill(params, p, bt, on(prompts[:1]), on([0]), on([seq]))
            streams[kv] = [lg[0, seq - 1].float().cpu()]
        tok = int(torch.argmax(streams[""][0]))
        for i in range(sched.max_new_tokens - 1):
            for kv, p in pools.items():
                lg, _, _ = decoder.paged_decode_step(params, p, bt, on([tok]), on([seq + i]))
                streams[kv].append(lg[0].float().cpu())
            tok = int(torch.argmax(streams[""][-1]))
    drift = max(float((a - b).abs().max()) for a, b in zip(streams[""], streams["int8"]))
    print(f"[{card}] tiny_gpt_paged_kv: kv_dtype={pool.kv_dtype} pages={pool.n_pages} page_size={pool.page_size} "
          f"build_s={build_s:.3f} warmup_s={warmup_s:.3f} {json.dumps(stats)} greedy agreement with the fused "
          f"generate={agree:.3f} int8 vs fp teacher-forced max logit drift={drift} (limit {INT8_KV_ATOL})", flush=True)
    if stats["hits"] <= 0 or stats["recompiles"] != 0 or stats["twin_recompiles"] != 0:
        raise AssertionError(f"tiny_gpt_paged_kv: no prefix hit or a new dispatch key: {stats}")
    if not 0.0 < drift < INT8_KV_ATOL:
        raise AssertionError(f"int8 KV logits drift {drift} from the fp pool's (limit {INT8_KV_ATOL}, and > 0)")


def shifted_mask_attention(q, k, v):
    """Causal attention whose mask lets each row see one key past itself."""
    import math

    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril(diagonal=1)
    return torch.matmul(torch.softmax(s.masked_fill(~keep, -1e30), dim=-1), v.float()).to(q.dtype)


def tile_dropped_attention(q, k, v):
    """Causal attention with keys KV_TILE..2*KV_TILE-1 masked out of every
    row: one 128-key tile dropped."""
    import math

    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
    keep[:, KV_TILE : 2 * KV_TILE] = False
    keep[:, 0] = True
    return torch.matmul(torch.softmax(s.masked_fill(~keep, -1e30), dim=-1), v.float()).to(q.dtype)


def causal_arms() -> dict:
    """The decoder's prefill attention run other ways: blockwise (no
    kernel), the kernel's plain version, and two wrong attentions."""
    from seldon_core_tpu_torch.ops.attention import blockwise_attention
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return {
        "blockwise": lambda q, k, v: blockwise_attention(q, k, v, block_size=512, causal=True),
        "plain_version": lambda q, k, v: flash_attention_reference(q, k, v, causal=True),
        "shifted_mask": shifted_mask_attention,
        "tile_dropped": tile_dropped_attention,
    }


async def serve_long_prompt(card) -> int:
    """Phase 5d: GPT-2-small widths, one 4096-token prompt per request,
    bf16. The prefill must launch the flash kernel once per layer; prompt
    logits within LONG_LOGITS_REL_L2 of blockwise attention and of the
    kernel's plain version, two wrong attentions outside it; greedy ids
    equal to both up to the tie rule; where the request's time goes.
    Returns the kernel launches of the path."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import decoder
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    server, build_s, warmup_s = await _start(BASELINE_DIR / "gpt2_small_long_prompt.json")
    runtime = _model_runtime(server)
    params, dims = runtime.params, decoder.decoder_dims(runtime.params)
    seq, max_new = runtime.generative["seq"], runtime.generative["max_new_tokens"]
    rng = np.random.default_rng(8)
    try:
        served, deltas, latencies = [], [], []
        LAUNCHES.reset()  # the path's run starts here
        for _ in range(2):
            ids = rng.integers(0, dims["vocab"], size=(1, seq))
            before = LAUNCHES.count
            status, _, body, ms = await _ids_post(server.port, ids)
            if status != 200:
                raise AssertionError(f"gpt2_small_long_prompt returned HTTP {status}: {body[:300]!r}")
            served.append((ids, np.asarray(json.loads(body)["data"]["ndarray"], np.int64)))
            deltas.append(LAUNCHES.count - before)
            latencies.append(ms)
        launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    print(f"[{card}] gpt2_small_long_prompt: {json.dumps(dims)} dtype={runtime.dtype} build_s={build_s:.3f} "
          f"warmup_s={warmup_s:.3f} latency_ms={[round(m, 3) for m in latencies]} kernel_launches={deltas}",
          flush=True)
    require_launches("gpt2_small_long_prompt flash_attention", deltas, dims["layers"])
    for ids, out in served:
        if out.shape != (1, seq + max_new) or not (out[:, :seq] == ids).all():
            raise AssertionError(f"gpt2_small_long_prompt served ids of shape {out.shape}")

    def prompt_logits(x):
        h = decoder._embed(params, x)
        for lp in params["layers"]:
            h, _, _ = decoder._layer_prefill(lp, h, dims["heads"])
        return decoder._logits(params, h)[0].float()

    ids = served[0][0]
    with torch.inference_mode():
        x = torch.from_numpy(ids).to(runtime.device)
        kernel_logits = prompt_logits(x)
        rows, ties = {}, {}
        for name, fn in causal_arms().items():
            with planted(decoder, "_causal_attention", fn):
                got = prompt_logits(x)
                rows[name] = rel_l2(got, kernel_logits)
                rows[f"{name}_first_token"] = rel_l2(got[-1], kernel_logits[-1])
                del got
                if name in ("blockwise", "plain_version"):
                    ref = decoder.generate(params, x, max_new).cpu().numpy()
                    ties[name] = tie_rule(f"gpt2_small_long_prompt vs {name}", served[0][1], ref, params, seq,
                                          "bfloat16")
    print(f"[{card}] gpt2_small_long_prompt prompt logits vs the kernel (relative L2; limit "
          f"{LONG_LOGITS_REL_L2}): {json.dumps(rows)}; greedy tie rows {ties}", flush=True)
    if max(rows[f"{a}{b}"] for a in ("blockwise", "plain_version") for b in ("", "_first_token")) > LONG_LOGITS_REL_L2:
        raise AssertionError(f"long-prompt logits disagree with the same weights run another way: {rows}")
    for name in ("shifted_mask", "tile_dropped"):
        if rows[name] <= LONG_LOGITS_REL_L2:
            raise AssertionError(f"the long-prompt check cannot see a wrong attention ({name}: {rows[name]})")
    long_breakdown(card, runtime, ids)
    return launches


def long_breakdown(card, runtime, ids) -> None:
    """Where one long-prompt request's device time goes: the request's host
    wall (ids in, ids back), device busy and idle share, the prefill's
    device time and the kernel's share of it, and the per-token decode
    device time."""
    import torch

    from seldon_core_tpu_torch.models.decoder import prefill

    max_new = runtime.generative["max_new_tokens"]
    x = torch.from_numpy(ids).to(runtime.device)

    def prefill_only():
        with torch.inference_mode():
            prefill(runtime.params, x)[0].cpu()

    wall = wall_ms(lambda: runtime.predict(ids), reps=3)
    total, ops = profile_device(lambda: runtime.predict(ids), reps=1)
    pre, _ = profile_device(prefill_only, reps=1)
    busy, pre_busy = sum(total.values()), sum(pre.values())
    flash = sum(t for k, t in pre.items() if "flash_fwd" in k)
    if busy > 0 and pre_busy > 0:
        device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f} "
                  f"prefill_device_ms={pre_busy:.4f} flash_ms={flash:.4f} flash_share_of_prefill={flash / pre_busy:.3f} "
                  f"decode_device_ms_per_token={(busy - pre_busy) / (max_new - 1):.4f}")
    else:
        device = "device time: not measured (the profiler saw no device activity)"
    print(f"[{card}] gpt2_small_long_prompt breakdown request_wall_ms={wall:.3f} "
          f"device_ops_per_request={ops:g} {device}", flush=True)
    for name, t in sorted(pre.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    prefill {t:.4f} ms  {name[:110]}")


SPEC_OFF = {"decode_draft_model": "", "decode_spec_k": 0, "decode_spec_tree": "", "decode_spec_accept_floor": 0.0}


def _spec_stats(sched) -> dict:
    return dict(rounds=sched.stat_steps, spec_dispatches=sched.stat_spec_dispatches,
                proposed=sched.stat_spec_proposed, accepted=sched.stat_spec_accepted,
                emitted=sched.stat_spec_emitted, rides=sched.stat_spec_rides)


async def _spec_traffic(port: int, prompts, budgets) -> tuple[list, float]:
    """SPEC_REQUESTS staggered requests with their own max_new_tokens, the
    second one tagged spec_k=0 (opted out): (replies, wall seconds)."""
    async def one(i):
        await asyncio.sleep(0.004 * i)
        tags = {"max_new_tokens": budgets[i], **({"spec_k": 0} if i == 1 else {})}
        return await _ids_post(port, prompts[i : i + 1], tags)

    t0 = time.perf_counter()
    replies = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    return replies, time.perf_counter() - t0


def _served_rows(label: str, replies, budgets, seq: int) -> list:
    import numpy as np

    rows = []
    for (status, _, body, _), b in zip(replies, budgets):
        out = json.loads(body) if status == 200 else {}
        if status != 200 or out["meta"]["tags"]["gen_lens"] != [b]:
            raise AssertionError(f"{label} returned HTTP {status}: {body[:300]!r}")
        rows.append(np.asarray(out["data"]["ndarray"], np.int64)[0][: seq + b])
    return rows


def _hold_ids(label: str, rows, ref_rows, params, seq: int, dtype_name: str) -> list:
    """Each served row against its reference row under the tie rule; the tie
    rows as (request, generated index, gap)."""
    ties = []
    for r, (a, b) in enumerate(zip(rows, ref_rows)):
        ties += [(r, *t[1:]) for t in tie_rule(label, [a], [b[: len(a)]], params, seq, dtype_name)]
    return ties


def _spec_prompts(sched, vocab: int, seed: int = 9):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(SPEC_REQUESTS, sched.seq_len))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=SPEC_REQUESTS)]
    budgets[0] = sched.max_new_tokens  # one request runs the whole budget
    return prompts, budgets


async def serve_speculative(card, path: Path, check_only: bool = False, twice: bool = True) -> dict:
    """Phase 6, one deployment: SPEC_REQUESTS staggered requests (mixed
    budgets, one opted out) through REST, on the speculative server and on
    a copy with speculation off, in turns (spec, plain, spec); every
    greedy row held to the plain scheduler's and to the fused generate's
    under the tie rule; one SSE stream against its buffered reply; no new
    dispatch key on either server; then the round's breakdown. Returns the
    numbers printed. ``check_only`` skips the timings and the breakdown
    (the tree and float32 copies); ``twice`` False serves one spec run, not
    two, so the repeat-run determinism check is skipped (the float32 copy)."""
    import numpy as np

    spec_srv, build_s, warmup_s = await _start(path)
    twin_srv, _, twin_warm = await _start(path, cuda_graphs=False)
    dep = json.loads(path.read_text())
    dep["spec"]["predictors"][0]["tpu"].update(SPEC_OFF)
    plain_path = ROOT / "build" / f"{path.stem}_plain.json"
    plain_path.parent.mkdir(exist_ok=True)
    plain_path.write_text(json.dumps(dep))
    plain_srv, _, _ = await _start(plain_path)
    sched, plain = spec_srv.decode_scheduler, plain_srv.decode_scheduler
    runtime = _model_runtime(spec_srv)
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    label = f"{path.stem} ({dtype_name})"
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    prompts, budgets = _spec_prompts(sched, vocab)
    # the second spec run holds the determinism check; one plain run keeps
    # the script's time
    order = ("spec", "plain", "spec") if twice else ("spec", "plain")
    runs = {"spec": [], "plain": []}
    try:
        for kind in order:
            srv = spec_srv if kind == "spec" else plain_srv
            before = _spec_stats(srv.decode_scheduler)
            replies, wall = await _spec_traffic(srv.port, prompts, budgets)
            after = _spec_stats(srv.decode_scheduler)
            runs[kind].append((replies, wall, {k: after[k] - before[k] for k in after}))
        twin_replies, twin_wall = await _spec_traffic(twin_srv.port, prompts, budgets)
        status, events = await _read_sse(spec_srv.port, prompts[:1])
        _, _, body, _ = await _ids_post(spec_srv.port, prompts[:1])
        buffered = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        recompiles = (sched.recompiles_since_warmup(), plain.recompiles_since_warmup(),
                      twin_srv.decode_scheduler.recompiles_since_warmup())
        breakdown = {} if check_only else spec_breakdown(card, sched, twin_srv.decode_scheduler, plain)
        carry = {}
        if sched.feature_draft:
            keys = sched.compile_counts()
            if sorted(keys) != sorted(FEATURE_KEYS + ("copy",)) or min(keys[k] for k in FEATURE_KEYS) < 1:
                raise AssertionError(f"{label}: feature dispatch keys {keys}, want each of {FEATURE_KEYS}")
            # speculative rounds (and, below the accept floor, plain ones),
            # then every round a step_f (every request opted out)
            carry = {"spec": await carry_check(card, spec_srv, label),
                     "spec_k_0": await carry_check(card, spec_srv, label, {"spec_k": 0})}
    finally:
        await spec_srv.stop()
        await plain_srv.stop()
        await twin_srv.stop()
    rows = _served_rows(label, runs["spec"][0][0], budgets, seq)
    hold_twin_rows(label, rows, _served_rows(f"{label} eager twin", twin_replies, budgets, seq))
    plain_rows = _served_rows(f"{label} plain", runs["plain"][0][0], budgets, seq)
    for replies, _, _ in runs["spec"][1:]:
        if any((a != b).any() for a, b in zip(_served_rows(label, replies, budgets, seq), rows)):
            raise AssertionError(f"{label}: two runs of the same greedy traffic served different ids")
    want = _fused_oracle(runtime, prompts)
    ties = {"plain_scheduler": _hold_ids(f"{label} vs the plain scheduler", rows, plain_rows, runtime.params, seq,
                                         dtype_name),
            "fused_generate": _hold_ids(f"{label} vs the fused generate", rows, want, runtime.params, seq,
                                        dtype_name)}
    tokens = [e["token"] for e in events if "token" in e]
    if tokens != buffered[seq:].tolist() or events[-1].get("ids") != [buffered.tolist()]:
        tail = buffered[seq:].tolist()
        first = next((i for i, (a, b) in enumerate(zip(tokens, tail)) if a != b), min(len(tokens), len(tail)))
        raise AssertionError(f"{label}: the SSE stream's tokens differ from the buffered reply from token "
                             f"{first}: streamed {tokens}, buffered {tail}")
    if recompiles != (0, 0, 0):
        raise AssertionError(f"{label}: new keys after warmup (spec, plain, eager twin): {recompiles}")
    st = runs["spec"][0][2]
    n_tok = sum(budgets)
    decode_tokens = n_tok - SPEC_REQUESTS  # each request's first token comes from its prompt's chunk round
    result = dict(
        deployment=path.stem, dtype=dtype_name, spec_k=sched.spec_k,
        tree=None if sched.spec_tree is None else ",".join(map(str, sched.spec_tree.branching)),
        requests=SPEC_REQUESTS, tokens=n_tok, rounds=st["rounds"], spec_rounds=st["spec_dispatches"],
        plain_rounds=runs["plain"][0][2]["rounds"],
        tokens_per_target_dispatch=decode_tokens / max(st["rounds"], 1),
        plain_tokens_per_target_dispatch=decode_tokens / max(runs["plain"][0][2]["rounds"], 1),
        accept_rate=st["accepted"] / max(st["proposed"], 1),
        mean_accepted_per_round=st["accepted"] / max(st["rides"], 1),
        ms_per_token=[w * 1e3 / n_tok for _, w, _ in runs["spec"]],
        plain_ms_per_token=[w * 1e3 / n_tok for _, w, _ in runs["plain"]],
        tie_rows=ties, sse_tokens=len(tokens), build_s=build_s, warmup_s=warmup_s,
        dispatch_keys=sched.compile_counts(), captures=sched.graphs.stat_captures,
        eager_rounds=sched.stat_eager_rounds, eager_twin_ms_per_token=twin_wall * 1e3 / n_tok,
        eager_twin_warmup_s=twin_warm,
        pool_bytes={"captured": spec_srv.warmup_reserved_bytes, "eager": twin_srv.warmup_reserved_bytes},
        **({"carry": carry} if carry else {}),
        **breakdown,
    )
    print(f"[{card}] speculative {json.dumps(result)}", flush=True)
    return result


def spec_breakdown(card, sched, twin, plain, reps: int = 5) -> dict:
    """One speculative round pair with every slot generating at its full
    limits (all-zero block tables: every pool write lands in junk page 0),
    captured and on the eager twin: host wall (the round ends in its
    readback), device busy, the draft's device time (its program alone;
    the verify's is the rest) and host share; and the plain step of the
    same model beside it."""
    import numpy as np
    import torch

    n, tree = sched.n_slots, sched.spec_tree
    z, zf = np.zeros(n, np.int32), np.zeros(n, np.float32)
    pos = np.full(n, sched.max_ctx - 1, np.int32)
    bt, limits = sched.pool.block_tables(), np.full(n, sched.spec_k, np.int32)
    wl = None if tree is None else np.tile(np.asarray(tree.branching, np.int32), (n, 1))

    def spec_round(s):
        s.pool.load_block_tables(bt)
        s._spec(z, pos, zf, z, limits, wl, 0)

    def draft_only(s):
        draft, _ = s._spec_entries(n)
        draft.load(z, pos, *s._feature_inputs(None)[0])
        draft.replay()
        torch.cuda.synchronize()

    plain_bt = plain.pool.block_tables()  # no spec_k headroom: fewer pages per slot

    def plain_step():
        plain.pool.load_block_tables(plain_bt)
        plain._step(z, pos, zf, z, 0)

    row = {}
    with torch.inference_mode():
        for mode, s in (("", sched), ("eager_", twin)):
            wall = wall_ms(lambda: spec_round(s), reps)
            total, ops = profile_device(lambda: spec_round(s))
            draft, draft_ops = profile_device(lambda: draft_only(s))
            busy, draft_ms = sum(total.values()), sum(draft.values())
            row[f"{mode}round_wall_ms"] = wall
            if busy > 0 and draft_ms > 0:
                row.update({f"{mode}round_device_ms": busy, f"{mode}draft_device_ms": draft_ms,
                            f"{mode}verify_device_ms": busy - draft_ms, f"{mode}host_share": max(0.0, 1 - busy / wall),
                            f"{mode}device_ops_per_round": ops, f"{mode}draft_device_ops": draft_ops})
        row["plain_step_wall_ms"] = wall_ms(plain_step, reps)
        plain_busy, plain_ops = profile_device(plain_step)
    plain_ms = sum(plain_busy.values())
    if plain_ms > 0:
        row.update(plain_step_device_ms=plain_ms, plain_step_host_share=max(0.0, 1 - plain_ms / row["plain_step_wall_ms"]),
                   plain_step_device_ops=plain_ops)
    if "round_device_ms" not in row:
        row["device"] = "not measured (the profiler saw no device activity)"
    return row


async def spec_faults(card, matched: dict) -> dict:
    """Phase 6's planted faults, each served through REST on the tiny
    deployments (float32) and held to the fused generate:
    - a draft from another seed must leave every greedy id unchanged while
      the accept rate falls below the matched draft's (speculation cannot
      change greedy output);
    - an acceptance that keeps one draft token past the first mismatch must
      fail the id check;
    - a tree commit that writes a sibling's K/V in place of the accepted
      node's must fail the id check."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.spec_tree import SpecTree
    from seldon_core_tpu_torch.serving import decode_scheduler as ds

    real_accept, real_commit = ds.speculative_accept, ds.paged_tree_commit

    def accept_one_past(target_logits, drafts, draft_logits, limits, temps, topks, gen):
        out, acc = real_accept(target_logits, drafts, draft_logits, limits, temps, topks, gen)
        past = acc < limits.to(acc.dtype)  # a draft existed there and lost: keep it anyway
        rows = torch.arange(out.shape[0], device=out.device)
        bonus = out[rows, acc.long()]
        acc2 = acc + past.to(acc.dtype)
        out2 = torch.cat([drafts.to(out.dtype), torch.zeros_like(out[:, :1])], dim=1)
        out2[rows, acc2.long()] = bonus
        return out2, acc2

    def sibling_of(tree) -> "np.ndarray":
        """Each block's next sibling under its parent (itself where its
        depth has branching 1)."""
        sib = np.arange(tree.width)
        for p in range(tree.width):
            kids = [int(c) for c in tree.child_table[p] if c]
            for i, c in enumerate(kids):
                sib[c] = kids[(i + 1) % len(kids)]
        return sib

    # the served tree's sibling table, on the card before its server
    # captures the planted commit (a capture refuses an upload)
    tree_path = BASELINE_DIR / "tiny_gpt_tree_speculation.json"
    tree_text = json.loads(tree_path.read_text())["spec"]["predictors"][0]["tpu"]["decode_spec_tree"]
    sibling = torch.as_tensor(sibling_of(SpecTree.from_text(tree_text)), device=DEVICE)

    def commit_sibling(pool, bt, new_k, new_v, path_idx, positions, n_acc):
        return real_commit(pool, bt, new_k, new_v, sibling[path_idx.long()].to(path_idx.dtype), positions, n_acc)

    out = {}
    cases = [
        ("other_seed_draft", _deployment_copy("tiny_gpt_speculative",
                                              {"decode_draft_model": "zoo://draft?layers=1&resid_scale=0.1&seed=7"}),
         None, False),
        ("accept_one_past_mismatch", BASELINE_DIR / "tiny_gpt_speculative.json",
         planted(ds, "speculative_accept", accept_one_past), True),
        # a draft equal to the target (all 4 layers) accepts every path, so
        # the commit runs at every depth; at resid_scale 1 the target's
        # logits depend enough on the K/V it attends to that a sibling's
        # K/V changes its ids (at 0.1 they barely move)
        ("tree_commit_sibling_kv", _deployment_copy("tiny_gpt_tree_speculation",
                                                    {"decode_draft_model": "zoo://draft?layers=4"},
                                                    {"resid_scale": "1.0"}),
         planted(ds, "paged_tree_commit", commit_sibling), True),
    ]
    for name, path, fault, must_fail in cases:
        # planted before the server starts: its warmup captures the fault
        with fault or contextlib.nullcontext():
            server, _, _ = await _start(path)
            sched, runtime = server.decode_scheduler, _model_runtime(server)
            if sched.spec_tree is not None and sched.spec_tree.branching != SpecTree.from_text(tree_text).branching:
                raise AssertionError(f"{name}: serves tree {sched.spec_tree.branching}, the sibling table is for "
                                     f"{tree_text}")
            prompts, budgets = _spec_prompts(sched, runtime.params["tok_emb"].shape[0])
            try:
                before = _spec_stats(sched)
                replies, _ = await _spec_traffic(server.port, prompts, budgets)
                st = {k: v - before[k] for k, v in _spec_stats(sched).items()}
            finally:
                await server.stop()
        rows = _served_rows(name, replies, budgets, sched.seq_len)
        want = _fused_oracle(runtime, prompts)
        try:
            ties = _hold_ids(name, rows, want, runtime.params, sched.seq_len, "float32")
            failed, why = False, f"tie rows {ties}"
        except AssertionError as e:
            failed, why = True, str(e)
        rate = st["accepted"] / max(st["proposed"], 1)
        out[name] = dict(id_check_failed=failed, accept_rate=rate, rows_differing=sum(
            int((a != b[: len(a)]).any()) for a, b in zip(rows, want)), detail=why[:200])
        print(f"[{card}] planted fault {name}: {json.dumps(out[name])}", flush=True)
        if failed != must_fail:
            raise AssertionError(f"planted fault {name}: the id check {'passed' if must_fail else 'failed'}: {why}")
    if not out["other_seed_draft"]["accept_rate"] < matched["accept_rate"]:
        raise AssertionError(f"another seed's draft accepted as often as the matched one: "
                             f"{out['other_seed_draft']['accept_rate']} vs {matched['accept_rate']}")
    return out


FEATURE_KEYS = ("step_f", "chunk_f", "draft_feat", "ftree_verify")
# the carried feature against the target's sequence_hidden recomputed on the
# card: max |carried - recomputed| over max |recomputed|, per slot. bf16:
# the paged programs and the dense prefill round each of 12 layers' sums in
# other orders (an ulp of bf16 is 2^-8 of a value); float32 with TF32 off
CARRY_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


async def carry_check(card, server, label: str, tags: dict | None = None, seed: int = 17) -> dict:
    """The feature carry: one greedy request per slot with mixed budgets
    through REST, then each slot's carried feature (``sched._feat``) against
    the target's ``sequence_hidden`` at the last position its last tenant
    consumed (every token but the last emitted one), recomputed on the
    card, within CARRY_TOL. Returns the worst error and the slots held."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import sequence_hidden

    sched, runtime = server.decode_scheduler, _model_runtime(server)
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    rng = np.random.default_rng(seed)
    n = sched.n_slots
    prompts = rng.integers(0, runtime.params["tok_emb"].shape[0], size=(n, sched.seq_len))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=n)]
    admitted = []  # (prompt bytes, slot), in admission order
    real = sched._install_admit

    def install(seq, slot, entry, reuse, t0):
        admitted.append((seq.prompt.tobytes(), slot))
        return real(seq, slot, entry, reuse, t0)

    sched._install_admit = install
    try:
        replies = await asyncio.gather(*(_ids_post(server.port, prompts[i : i + 1],
                                                   {"max_new_tokens": budgets[i], **(tags or {})}) for i in range(n)))
    finally:
        del sched._install_admit
    rows = {p.astype(np.int32).tobytes(): r  # the key of a _Seq's int32 prompt
            for p, r in zip(prompts, _served_rows(f"{label} carry", replies, budgets, sched.seq_len))}
    last = {slot: key for key, slot in admitted}  # each slot's last tenant
    errs = {}
    with torch.inference_mode():
        for slot, key in last.items():
            consumed = torch.as_tensor(rows[key][:-1][None], device=runtime.device)
            ref = sequence_hidden(runtime.params, consumed)[1][0, -1].float()
            got = sched._feat[slot].float()
            errs[slot] = float((got - ref).abs().max() / ref.abs().max())
    worst = max(errs.values())
    out = {"slots": len(errs), "worst_rel_err": worst, "tol": CARRY_TOL[dtype_name], "tags": tags or {}}
    print(f"[{card}] feature carry {label}: {json.dumps(out)}", flush=True)
    if worst > CARRY_TOL[dtype_name]:
        raise AssertionError(f"{label}: carried features off the target's hidden by {errs} (tol "
                             f"{CARRY_TOL[dtype_name]})")
    return out


async def feature_faults(card) -> dict:
    """Phase 6's planted faults of the feature draft, each on a copy of
    tiny_gpt_feature_draft (float32) with the accept floor off, so every
    round speculates:
    - a step_f that leaves the carry stale must fail the carry check (on
      requests that opt out: every round a step_f);
    - an ftree_verify that accepts one draft token past the first
      mismatch must fail the id check against the fused generate."""
    import torch

    from seldon_core_tpu_torch.models.decoder import _tree_tables, paged_decode_step
    from seldon_core_tpu_torch.serving import decode_scheduler as ds

    real_accept = ds.speculative_accept_tree

    def stale_step(params, pool, bt, tokens, positions, feats, fmask):
        return paged_decode_step(params, pool, bt, tokens, positions)[0]

    def accept_one_past(target_logits, block_tokens, draft_logits, wl, temps, topks, gen, tree):
        out, acc, path = real_accept(target_logits, block_tokens, draft_logits, wl, temps, topks, gen, tree)
        rows = torch.arange(out.shape[0], device=out.device)
        a = acc.long()
        past = a < (wl > 0).sum(dim=1)  # a candidate existed there and lost: keep its first anyway
        nxt = _tree_tables(tree, out.device)[2][path[rows, a].long(), 0]
        a2 = torch.where(past, a + 1, a)
        bonus = out[rows, a]
        path2, out2 = path.clone(), out.clone()
        path2[rows, a2] = torch.where(past, nxt.to(path.dtype), path[rows, a2])
        out2[rows, a] = torch.where(past, block_tokens[rows, nxt].to(out.dtype), bonus)
        out2[rows, a2] = bonus
        return out2, a2.to(acc.dtype), path2

    path = _deployment_copy("tiny_gpt_feature_draft", {"decode_spec_accept_floor": 0.0})
    out = {}
    with planted(ds, "_step_feat_logits", stale_step):
        server, *_ = await _start(path)
        try:
            await carry_check(card, server, "stale step_f carry (planted)", {"spec_k": 0})
        except AssertionError as e:
            out["step_f_stale_carry"] = {"carry_check_failed": True, "detail": str(e)[:200]}
        else:
            raise AssertionError("planted fault step_f_stale_carry passed the carry check")
        finally:
            await server.stop()
    with planted(ds, "speculative_accept_tree", accept_one_past):
        server, *_ = await _start(path)
        sched, runtime = server.decode_scheduler, _model_runtime(server)
        prompts, budgets = _spec_prompts(sched, runtime.params["tok_emb"].shape[0])
        try:
            replies, _ = await _spec_traffic(server.port, prompts, budgets)
        finally:
            await server.stop()
    rows = _served_rows("ftree_verify one past", replies, budgets, sched.seq_len)
    try:
        _hold_ids("ftree_verify one past (planted)", rows, _fused_oracle(runtime, prompts), runtime.params,
                  sched.seq_len, "float32")
    except AssertionError as e:
        out["ftree_verify_one_past_mismatch"] = {"id_check_failed": True, "detail": str(e)[:200]}
    else:
        raise AssertionError("planted fault ftree_verify_one_past_mismatch passed the id check")
    for name, row in out.items():
        print(f"[{card}] planted fault {name}: {json.dumps(row)}", flush=True)
    return out


async def serve_speculation(card) -> dict:
    """Phase 6: the three speculative deployments (and the GPT-2-small tree
    copy) through REST, the float32 copies, the planted faults. Returns the
    per-deployment numbers."""
    results = {}
    for name in ("tiny_gpt_speculative", "tiny_gpt_tree_speculation", "gpt2_small_speculative"):
        t0 = time.perf_counter()
        results[name] = await serve_speculative(card, BASELINE_DIR / f"{name}.json")
        print(f"[{card}] phase 6 {name} seconds: {time.perf_counter() - t0:.3f}", flush=True)
    tree_copy = _deployment_copy("gpt2_small_speculative", {"decode_spec_tree": "2,2,1,1"})
    # the tree copies: ids held, twice, with no timings (the script's time)
    results["gpt2_small_speculative_tree"] = await serve_speculative(card, tree_copy, check_only=True)
    # the GPT-2-small chain in float32 (TF32 off): ids held at the float32
    # margin, at 4 of its 12 layers (the id check holds at any depth and
    # this copy prints no timing), to keep the script's time
    f32 = _deployment_copy("gpt2_small_speculative", {"dtype": "float32"}, {"layers": "4"})
    results["gpt2_small_speculative_f32"] = await serve_speculative(card, f32, check_only=True, twice=False)
    gpt2 = results["gpt2_small_speculative"]
    if gpt2["mean_accepted_per_round"] < SPEC_MIN_ACCEPTED:
        raise AssertionError(f"the GPT-2-small chain accepted {gpt2['mean_accepted_per_round']} draft tokens per "
                             f"round, want >= {SPEC_MIN_ACCEPTED}")
    results["faults"] = await spec_faults(card, results["tiny_gpt_speculative"])
    # the feature draft: the two deployments, a copy at the truncated tree
    # copy's shape and floor (none), the carry check (inside each), faults
    for name in ("tiny_gpt_feature_draft", "gpt2_small_feature_draft"):
        results[name] = await serve_speculative(card, BASELINE_DIR / f"{name}.json")
    # every round speculates and emits one token a slot: the eager twin's
    # second wave waits longer for a slot than the 2 s default queue timeout
    ftree = _deployment_copy("gpt2_small_feature_draft", {"decode_spec_tree": "2,2,1,1",
                                                          "decode_spec_accept_floor": 0.0, "queue_timeout_ms": 30000.0})
    results["gpt2_small_feature_draft_tree"] = await serve_speculative(card, ftree, check_only=True)
    results["feature_faults"] = await feature_faults(card)
    return results


def int8_weights(k: int, n: int, rng):
    """One quantized [k, n] weight (payload, scale) whose columns differ in
    magnitude, which is why the scheme keeps a scale per column."""
    import numpy as np

    from seldon_core_tpu_torch.models.quant import payload, quantize_params

    w = rng.standard_normal((k, n)) * np.exp(rng.uniform(-1.0, 1.0, n)) / np.sqrt(k)
    leaf = quantize_params({"w": w.astype(np.float32)})["w"]
    return payload(leaf), leaf["scale"]


def int8_bound(e, m, k, n, dtype_name, shared_x):
    """Least time for the call on an H100 SXM: x read once (once for all
    members when shared), each member's int8 payload, scales and bias read
    once and y written once at HBM rate, against 2*M*N*K operations per
    member at the activation dtype's peak."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = m * k * elem * (1 if shared_x else e) + e * (k * n + 4 * n + elem * n + elem * m * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * e * m * n * k / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_planted(x, q, s, b, k_tile: int) -> dict:
    """The plain version with a planted fault: scales applied per row (row k
    takes column k mod N's scale), or one K tile of x dropped (the second
    tile, or half of a K shorter than two tiles)."""
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import _batched_reference

    k, n = q.shape[1], q.shape[2]
    rows = torch.arange(k, device=q.device) % n
    per_row = (q.float() * s[:, rows][:, :, None]).to(x.dtype)
    t = max(1, min(k_tile, k // 2))
    keep = torch.ones(k, device=x.device, dtype=x.dtype)
    keep[t:2 * t] = 0
    return {
        "scale_per_row": torch.matmul(x, per_row) + b[:, None, :],
        "k_tile_dropped": _batched_reference(x * keep, q, s, b),
    }


def check_int8(case, card) -> dict:
    """One W8A16 kernel-vs-plain case on the card: x [E, M, K] (one x
    shared by the E members when ``shared``, as a fused ensemble's input
    is), E quantized [K, N] weights, a bias; E > 1 goes through the vmap
    rule, as graph fusion calls it. The call must launch once, on ``body``.
    Returns the case's numbers."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.int8_matmul import _batched_reference, int8_matmul

    name, (e, m, k, n), dtype, shared, body = case
    dtype_name = str(dtype).removeprefix("torch.")
    rng = np.random.default_rng(len(name) * 7919 + m + k + n)
    weights = [int8_weights(k, n, rng) for _ in range(e)]
    q = torch.from_numpy(np.stack([w for w, _ in weights])).cuda()
    s = torch.from_numpy(np.stack([sc for _, sc in weights])).reshape(e, n).cuda()
    b = torch.from_numpy(rng.standard_normal((e, n)).astype(np.float32) * 0.1).cuda().to(dtype)
    x1 = torch.from_numpy(rng.standard_normal((1 if shared else e, m, k)).astype(np.float32)).cuda().to(dtype)
    x = x1.expand(e, m, k)
    if e == 1:
        def call():
            return int8_matmul(x1[0], q[0], s[0], b[0])[None]
    else:
        fused = torch.func.vmap(int8_matmul, in_dims=(None if shared else 0, 0, 0, 0))

        def call():
            return fused(x1[0] if shared else x1, q, s, b)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # the plain version sums in f32
    try:
        before = {name_: c.count for name_, c in i8.LAUNCHES_BY_BODY.items()}
        out = call()
        torch.cuda.synchronize()
        launched = {name_: c.count - before[name_] for name_, c in i8.LAUNCHES_BY_BODY.items()}
        ref = _batched_reference(x, q, s, b)
        agree = agreement(out, ref, dtype_name)
        planted = {f: agreement(y, ref, dtype_name)
                   for f, y in int8_planted(x, q, s, b, INT8_K_TILE[dtype_name]).items()}
        w = (q.float() * s[:, None, :]).to(dtype)
        ms = device_ms(call)
        # the simple body on the same inputs, where the wgmma body served
        ms_mma = device_ms(lambda: i8._launch(x, q, s, b, body="mma")) if body == "wgmma" else None
        plain_ms = device_ms(lambda: _batched_reference(x, q, s, b))
        if e == 1:
            library_ms = device_ms(lambda: torch.addmm(b[0], x1[0], w[0]))
        else:
            library_ms = device_ms(lambda: torch.baddbmm(b[:, None, :], x, w))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    bound_ms, bound_by = int8_bound(e, m, k, n, dtype_name, shared)
    row = dict(
        case=name, shape=[e, m, k, n], dtype=dtype_name, shared_x=shared, body=body,
        max_abs_err=agree["max_abs_err"], atol=agree["atol"], rel_l2=agree["rel_l2"],
        rel_l2_limit=agree["rel_l2_limit"],
        planted_faults={f: dict(max_abs_err=a["max_abs_err"], rel_l2=a["rel_l2"], caught=not a["ok"])
                        for f, a in planted.items()},
        ms=ms, ms_mma=ms_mma, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
    )
    print(f"[{card}] int8_matmul {json.dumps(row)}", flush=True)
    if launched != {name_: int(name_ == body) for name_ in launched}:
        raise AssertionError(f"int8_matmul {name}: want one launch on the {body} body, got {launched}")
    if not agree["ok"]:
        raise AssertionError(f"int8_matmul {name}: kernel disagrees with its plain version: {agree}")
    for fault, a in planted.items():
        if a["ok"]:
            raise AssertionError(f"int8_matmul {name}: the check passes a planted fault ({fault}): {a}")
    return row


INT8_SHAPES = [  # name, (E, M, K, N), x shared by the members, the bf16 body
    # BERT-base's projections at bucket 32 x seq 128 (M = 4096), and its head
    ("qkv_b32", (1, 4096, 768, 2304), False, "wgmma"),
    ("attn_out_b32", (1, 4096, 768, 768), False, "wgmma"),
    ("mlp_in_b32", (1, 4096, 768, 3072), False, "wgmma"),
    ("mlp_out_b32", (1, 4096, 3072, 768), False, "wgmma"),
    ("head_b32", (1, 32, 768, 2), False, "mma"),
    # the Hugging Face pooler of bert_base_hf_int8 (phase 11): [CLS] rows
    ("pooler_b32", (1, 32, 768, 768), False, "wgmma"),
    # the same at bucket 1 (M = 128 rows, the head one)
    ("qkv_b1", (1, 128, 768, 2304), False, "wgmma"),
    ("attn_out_b1", (1, 128, 768, 768), False, "wgmma"),
    ("mlp_in_b1", (1, 128, 768, 3072), False, "wgmma"),
    ("mlp_out_b1", (1, 128, 3072, 768), False, "wgmma"),
    ("head_b1", (1, 1, 768, 2), False, "mma"),
    # iris: K = 4, N = 3, ragged everywhere
    ("iris", (1, 5, 4, 3), False, "mma"),
    # the wgmma body's edges: M % 128 != 0, K % 64 != 0, N % 128 != 0
    ("m_ragged", (1, 4000, 768, 2304), False, "wgmma"),
    ("k_ragged", (1, 256, 776, 768), False, "wgmma"),
    ("n_ragged", (1, 256, 768, 400), False, "wgmma"),
    # one position's shards of int8 BERT-base over {"model": 4} at bucket 8 x
    # seq 512 (phase 18c): qkv's q, k and v column slabs, attn_out's rows
    # (no bias: it follows the psum), mlp_in's columns, mlp_out's rows
    ("tp4_qkv_b8", (1, 4096, 768, 576), False, "wgmma"),
    ("tp4_attn_out_b8", (1, 4096, 192, 768), False, "wgmma"),
    ("tp4_mlp_in_b8", (1, 4096, 768, 768), False, "wgmma"),
    ("tp4_mlp_out_b8", (1, 4096, 768, 768), False, "wgmma"),
    # a fused ensemble of three members: the shared input, then per-member
    # rows; K = 776 ends mid-tile, where a read across a member's edge shows
    ("stacked_e3_shared_x", (3, 256, 768, 768), True, "wgmma"),
    ("stacked_e3", (3, 256, 768, 768), False, "wgmma"),
    ("stacked_e3_k776_shared_x", (3, 256, 776, 768), True, "wgmma"),
    ("stacked_e3_k776", (3, 256, 776, 768), False, "wgmma"),
]


def int8_kernel_checks(card) -> dict:
    """Phase 7b: every INT8_SHAPES case in bfloat16 and float32 (fma)."""
    import torch

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, shared, body in INT8_SHAPES:
            label = f"{name}_{str(dtype).removeprefix('torch.')}"
            body = body if dtype == torch.bfloat16 else "fma"
            rows[label] = check_int8((label, shape, dtype, shared, body), card)
    return rows


def int8_host_cost(card, calls: int = 200) -> dict:
    """Host microseconds per W8A16 call at the qkv bucket-32 shape (the
    whole wrapper: checks, body rule, ctypes, x's tensor map, launch) and
    torch.addmm on the pre-dequantized weights beside it.
    Medians of ``calls`` calls, no synchronisation inside the loop."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul

    qw, sc = int8_weights(768, 2304, np.random.default_rng(5))
    q, s = torch.from_numpy(qw).cuda(), torch.from_numpy(sc).reshape(-1).cuda()
    b = torch.zeros(2304, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(4096, 768, device="cuda").to(torch.bfloat16)
    w = (q.float() * s).to(torch.bfloat16)
    walls, lib_walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        int8_matmul(x, q, s, b)
        walls.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        torch.addmm(b, x, w)
        lib_walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(wrapper_us=med(walls), library_call_us=med(lib_walls))
    print(f"[{card}] int8_matmul host cost per call (4096, 768 -> 2304): {json.dumps(row)}", flush=True)
    return row


def param_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (int8 payloads and float32
    scales of quantized leaves included)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return 0


def int8_breakdown(card, label: str, runtime, ids) -> dict:
    """Host wall time of one served forward at the runtime's bucket (ids in,
    probabilities back on the host), the device's busy time inside it and
    the W8A16 kernel's part of that (torch.profiler), and the costliest
    kernels."""
    kernels, ops = profile_device(lambda: runtime.predict(ids))
    wall = wall_ms(lambda: runtime.predict(ids))
    busy = sum(kernels.values())
    int8 = sum(t for k, t in kernels.items() if any(b in k for b in ("wgmma_body", "mma_body", "fma_body")))
    row = dict(predict_wall_ms=wall, device_ops_per_forward=ops)
    if busy > 0:
        row.update(device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall), int8_kernel_ms=int8,
                   int8_share_of_busy=int8 / busy)
    print(f"[{card}] breakdown {label} rows={len(ids)} {json.dumps(row)}"
          + ("" if busy > 0 else " device time: not measured (the profiler saw no device activity)"), flush=True)
    for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {t:.4f} ms  {name[:110]}")
    return row


async def serve_bert_int8(card, name: str = "bert_int8", want: int | None = None,
                          want_by_body: dict | None = None) -> int:
    """Phase 7c: the bert_int8 deployment (BERT-base, bf16, bucket 32, seq
    128, int8 weights) through REST: 49 W8A16 launches per forward, counted;
    its probabilities against the same weights' bf16 deployment without
    weight_quant (INT8_SERVE_ATOL) and against the port's int8 forward on
    the CPU (SERVE_ATOL, the first rows: the forward is row-independent);
    the parameter bytes each holds on the card; a profiler breakdown and the
    wall time at bucket 32. Returns the main path's launches, in all and
    by body. Phase 11 runs it on ``bert_base_hf_int8`` (``name``) with the
    pooler's launch added to ``want`` (default INT8_LAUNCHES) and
    ``want_by_body`` (default INT8_LAUNCHES_BY_BODY)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch
    from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload
    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.int8_matmul import LAUNCHES as INT8

    want = INT8_LAUNCHES if want is None else want
    want_by_body = INT8_LAUNCHES_BY_BODY if want_by_body is None else want_by_body
    server, build_s, warm_s = await _start(BASELINE_DIR / f"{name}.json")
    runtime = _model_runtime(server)
    layers, seq = len(runtime.params["layers"]), runtime.feature_shape[0]
    table = runtime.params["tok_emb"]  # 30522 rows: above the rule's 8192, so not quantized
    vocab = (payload(table) if is_quantized_leaf(table) else table).shape[0]
    if not is_quantized_leaf(runtime.params["layers"][0]["qkv"]["w"]) or not is_quantized_leaf(runtime.params["head"]["w"]):
        raise AssertionError(f"{name} holds float projections")
    print(f"[{card}] serve: {name}.json layers={layers} seq={seq} vocab={vocab} dtype={runtime.dtype} "
          f"buckets={runtime.buckets} build_s={build_s:.3f} warmup_s={warm_s:.3f}", flush=True)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, vocab, size=(n, seq)) for n in (32, 5, 32)]
    served, deltas, body_deltas, latencies = [], [], [], []
    try:
        i8.reset_launches()  # the main path's run starts here
        for ids in batches:
            before = INT8.count
            by_body = {body: c.count for body, c in i8.LAUNCHES_BY_BODY.items()}
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"{name} predict returned HTTP {status}: {out}")
            served.append(_check_probs(out, len(ids)))
            deltas.append(INT8.count - before)
            body_deltas.append({body: c.count - by_body[body] for body, c in i8.LAUNCHES_BY_BODY.items()})
            latencies.append(ms)
        main_launches = INT8.count  # ... and ends here
        main_by_body = {body: c.count for body, c in i8.LAUNCHES_BY_BODY.items()}
    finally:
        await server.stop()
    for ids, ms, delta, by_body in zip(batches, latencies, deltas, body_deltas):
        print(f"[{card}] request {name} batch={len(ids)} latency_ms={ms:.3f} int8_launches={delta} "
              f"by_body={json.dumps(by_body)}", flush=True)
    require_launches(f"{name} int8_matmul", deltas, want)
    if body_deltas != [want_by_body] * len(batches):
        raise AssertionError(f"{name} int8_matmul launches per body and request {body_deltas}, "
                             f"want {want_by_body} each")

    bf16_server, *_ = await _start(_deployment_copy(name, {"weight_quant": ""}))
    bf16 = _model_runtime(bf16_server)
    await bf16_server.stop()
    vs_bf16 = max(float(np.abs(p - bf16.predict(ids)).max()) for ids, p in zip(batches, served))
    cpu_rows = 4
    cpu_params = params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)
    with torch.inference_mode():
        cpu_ids = torch.from_numpy(batches[0][:cpu_rows].astype(np.int32))
        on_cpu = runtime.apply_fn(cpu_params, cpu_ids).float().numpy()
    del cpu_params
    vs_cpu = float(np.abs(served[0][:cpu_rows] - on_cpu).max())
    resident = {"int8": param_bytes(runtime.params), "bf16": param_bytes(bf16.params)}
    print(f"[{card}] {name} vs the bf16 deployment: max_abs_diff={vs_bf16} (atol {INT8_SERVE_ATOL}); "
          f"vs the int8 forward on the CPU ({cpu_rows} rows): {vs_cpu} (atol {SERVE_ATOL})", flush=True)
    print(f"[{card}] {name} parameter bytes on the card: {json.dumps(resident)} "
          f"ratio={resident['int8'] / resident['bf16']:.4f}", flush=True)
    if vs_bf16 > INT8_SERVE_ATOL or vs_cpu > SERVE_ATOL:
        raise AssertionError(f"{name} disagrees: vs bf16 {vs_bf16}, vs the CPU {vs_cpu}")
    if resident["int8"] >= resident["bf16"]:
        raise AssertionError(f"int8 parameters take no fewer bytes than bf16: {resident}")
    ids32 = batches[0]
    int8_row = int8_breakdown(card, name, runtime, ids32)
    bf16_row = int8_breakdown(card, f"{name} without weight_quant (bf16)", bf16, ids32)
    print(f"[{card}] {name} bucket 32 wall: int8 {int8_row['predict_wall_ms']:.3f} ms, bf16 "
          f"{bf16_row['predict_wall_ms']:.3f} ms", flush=True)
    del bf16
    return main_launches, main_by_body


def _primary_only(name: str) -> Path:
    """A copy of a deployment whose root router is dropped: its child 0 as
    the whole graph (``iris_fallback_breaker``'s breakered primary with no
    fallback above it; ``iris_shadow`` with the candidate removed)."""
    dep = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    pred = dep["spec"]["predictors"][0]
    pred["graph"] = pred["graph"]["children"][0]
    path = ROOT / "build" / f"{name}_primary_only.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


async def serve_resilience(card) -> dict:
    """Phase 7d: iris_fallback_breaker on the card, as the example stands,
    with faults installed on its primary: a failing primary is served by the
    fallback (200, degraded, routing restamped) and opens its breaker; a
    hang is cut by a 50 ms deadline tag (504, code 304); a breakered node
    without a fallback answers 500 (code 103), then 503 (code 305) with
    Retry-After; with batch_across_requests false, concurrent requests walk
    one each."""
    import numpy as np

    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults

    path = BASELINE_DIR / "iris_fallback_breaker.json"
    body = json.dumps({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}).encode()
    results = {}

    server, *_ = await _start(path)
    try:
        sched = install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        replies = [await _post(server.port, body) for _ in range(4)]
        breaker = server.executor.breaker_for("iris-primary").state
    finally:
        await server.stop()
    for status, out, _ in replies:
        if status != 200 or out["meta"]["tags"].get("degraded") != "router_fallback" \
                or out["meta"]["routing"] != {"router": 1}:
            raise AssertionError(f"a failing primary was not served by the fallback: {status} {out}")
        _check_probs(out, 1, classes=3)
    if sched["iris-primary"].calls != 5 or breaker != "open":
        raise AssertionError(f"primary calls {sched['iris-primary'].calls} (want 5), breaker {breaker} (want open)")
    results["fallback"] = dict(statuses=[r[0] for r in replies], ms=[r[2] for r in replies],
                               primary_calls=sched["iris-primary"].calls, breaker=breaker)

    server, *_ = await _start(path)
    try:
        # a 2 s hang: the deadline answers at 50 ms; the merged batch walk
        # it was cut from runs on until the hang ends, and stop() waits
        install_faults(server.executor, {"iris-primary": FaultSpec(timeout_rate=1.0, hang_s=2.0, seed=5)})
        tagged = json.dumps({"meta": {"tags": {"deadline_ms": 50}},
                             "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}).encode()
        status, out, ms = await _post(server.port, tagged)
    finally:
        await server.stop()
    if (status, out.get("code")) != (504, 304):
        raise AssertionError(f"a hang under a 50 ms deadline answered {status} {out}")
    results["deadline"] = dict(status=status, code=out["code"], ms=ms)

    server, *_ = await _start(_primary_only("iris_fallback_breaker"))
    try:
        install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        first = await _request(server.port, body)
        second = await _request(server.port, body)
    finally:
        await server.stop()
    got = [(r[0], json.loads(r[2])["code"]) for r in (first, second)]
    if got != [(500, 103), (503, 305)] or int(second[1].get("retry-after", "0")) < 1:
        raise AssertionError(f"a breakered node without fallback answered {got}, headers {second[1]}")
    results["no_fallback"] = dict(replies=got, retry_after=second[1]["retry-after"])

    for across in (True, False):
        server, *_ = await _start(_deployment_copy("iris_fallback_breaker", {"batch_across_requests": across}))
        try:
            sched = install_faults(server.executor, {"iris-primary": FaultSpec()})
            bodies = [json.dumps({"data": {"ndarray": [[float(i), 3.5, 1.4, 0.2]]}}).encode() for i in range(8)]
            replies = await asyncio.gather(*(_post(server.port, b) for b in bodies))
            walks, batcher = sched["iris-primary"].calls, server.batcher is not None
        finally:
            await server.stop()
        if any(r[0] != 200 for r in replies):
            raise AssertionError(f"batch_across_requests={across}: {[r[0] for r in replies]}")
        if not across and (walks != 8 or batcher):
            raise AssertionError(f"batch_across_requests false walked {walks} times for 8 requests (batcher {batcher})")
        results[f"batch_across_requests_{str(across).lower()}"] = dict(requests=8, primary_calls=walks)
    print(f"[{card}] iris_fallback_breaker: {json.dumps(results)}", flush=True)
    return results


# ------------------------------------------------ captured against eager
# Every runtime and decode scheduler serves its dispatch keys as captured
# CUDA graphs (seldon_core_tpu_torch/ops/graphs.py); the eager twin
# (cuda_graphs=False) runs the same keys eagerly on the same static buffers.
# The same kernels run with the same launch configurations either way, so
# the twins must agree bit for bit, and the launch counters (credited per
# replay on the captured side) must read the same.
LOAD_SECONDS = 0.5  # per load point (cut from 1.5, then 1.0, to keep the script's time)
LOAD_USERS = (8, 16, 32)  # the saturating point: the first whose successor rises <= 10%
LOAD_RISE = 1.10
LOAD_WORKERS = 2  # client processes of a multi-user point


def _runtimes(server) -> list:
    """(node name, runtime) of every model node of a server's graph."""
    return [(n.name, n.unit.runtime) for n in server.executor.root.walk()
            if getattr(n.unit, "runtime", None) is not None]


def _launch_counts() -> dict:
    from seldon_core_tpu_torch.ops import flash_attention, int8_matmul

    return {"flash_attention": flash_attention.LAUNCHES.count, "int8_matmul": int8_matmul.LAUNCHES.count,
            **{f"int8_{b}": c.count for b, c in int8_matmul.LAUNCHES_BY_BODY.items()}}


def _launches_of(fn) -> dict:
    """The kernel launches ``fn`` made (on a captured path: the launches
    its replays credited), by counter, zeros left out."""
    before = _launch_counts()
    fn()
    return {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}


def _twin_input(runtime, n: int, wire, rng):
    import numpy as np

    from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload

    shape = tuple(runtime.feature_shape)
    if wire == np.int32:
        table = runtime.params["tok_emb"]
        vocab = (payload(table) if is_quantized_leaf(table) else table).shape[0]
        return rng.integers(0, vocab, size=(n, *shape)).astype(np.int32)
    if wire == np.uint8:
        return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)
    return rng.uniform(0, 8, size=(n, *shape)).astype(np.float32)


def _wires(runtime) -> list:
    import numpy as np

    if runtime.int_inputs == "ids":
        return [np.int32]
    return [np.float32, np.uint8] if runtime._uint8_wire() else [np.float32]


def _modes_breakdown(card, label: str, fns: dict, unit: str, reps: int = 5) -> dict:
    """Host wall and device busy time of one call of each mode's ``fn``
    (which must end on the host), and the host share."""
    out = {}
    for mode, fn in fns.items():
        wall = wall_ms(fn, reps)
        kernels, ops = profile_device(fn)
        busy = sum(kernels.values())
        row = dict(wall_ms=wall, device_ops=ops)
        if busy > 0:
            row.update(device_ms=busy, host_share=max(0.0, 1 - busy / wall))
        out[mode] = row
        print(f"[{card}] {label} {unit} mode={mode} {json.dumps(row)}"
              + ("" if busy > 0 else " device time: not measured (the profiler saw no device activity)"), flush=True)
    return out


def check_twin_runtimes(card, label: str, cap, eager, kernels: tuple = ()) -> dict:
    """Every runtime of the captured server against its eager twin: at
    every bucket and wire dtype the same rows bit for bit and the same
    kernel launches (the captured side's credited by its replays; a kernel
    in ``kernels`` must launch on both, so a captured path that reports 0
    fails here); each key one captured graph; the forward's wall and device
    time at the smallest and largest bucket in both modes."""
    import numpy as np

    rng = np.random.default_rng(11)
    rows = {}
    for (node, rc), (_, re) in zip(_runtimes(cap), _runtimes(eager)):
        if not rc.graphs.capture or re.graphs.capture:
            raise AssertionError(f"{label}/{node}: the captured server does not capture or its twin does")
        if rc.graphs.stat_captures != sum(rc.compile_counts().values()):
            raise AssertionError(f"{label}/{node}: {rc.graphs.stat_captures} captures for keys {rc.compile_counts()}")
        launches = {}
        for b in rc.buckets:
            for wire in _wires(rc):
                x = _twin_input(rc, b, wire, rng)
                got = {}
                per = {mode: _launches_of(lambda rt=rt, mode=mode: got.__setitem__(mode, rt.predict(x)))
                       for mode, rt in (("captured", rc), ("eager", re))}
                if not np.array_equal(got["captured"], got["eager"]):
                    diff = float(np.abs(got["captured"].astype(np.float64) - got["eager"]).max())
                    raise AssertionError(f"{label}/{node} bucket {b} {np.dtype(wire).name}: captured rows differ "
                                         f"from the eager twin's (max abs {diff})")
                if per["captured"] != per["eager"]:
                    raise AssertionError(f"{label}/{node} bucket {b}: replays credited {per['captured']}, the eager "
                                         f"twin launched {per['eager']}")
                for k in kernels:
                    if per["captured"].get(k, 0) <= 0:
                        raise AssertionError(f"{label}/{node} bucket {b}: the captured path reports 0 {k} launches "
                                             "(its replays credit none)")
                launches[b] = per["captured"]
        print(f"[{card}] twins {label}/{node}: buckets={list(rc.buckets)} wires="
              f"{[np.dtype(w).name for w in _wires(rc)]} captured rows equal to the eager twin's bit for bit; "
              f"launches per forward (credited by replays) {json.dumps(launches)}; compile_counts "
              f"{rc.compile_counts()} captures={rc.graphs.stat_captures} replays={rc.graphs.stat_replays}", flush=True)
        for b in sorted({rc.buckets[0], rc.buckets[-1]}):
            x = _twin_input(rc, b, _wires(rc)[-1], rng)
            rows[f"{node}_b{b}"] = _modes_breakdown(
                card, f"twins {label}/{node} bucket={b}",
                {"captured": lambda: rc.predict(x), "eager": lambda: re.predict(x)}, "forward")
    return rows


async def _load_point(port: int, users: int, load: dict) -> dict:
    """One closed-loop load point from the port's load generator, run as
    its CLI in other processes so the server keeps its own."""
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.tools.loadtest", f"http://127.0.0.1:{port}",
           "--users", str(users), "--duration", str(LOAD_SECONDS), "--workers", str(1 if users == 1 else LOAD_WORKERS),
           "--static-payload", "--json", "--payload", load["payload"]]
    if "oauth" in load:  # through the gateway: a token first, then Bearer on every request
        cmd += ["--oauth-key", load["oauth"][0], "--oauth-secret", load["oauth"][1]]
    shape = load["features"]
    cmd += ["--features", str(shape)] if isinstance(shape, int) else ["--shape", ",".join(map(str, shape))]
    proc = await asyncio.create_subprocess_exec(*cmd, stdout=asyncio.subprocess.PIPE,
                                                stderr=asyncio.subprocess.PIPE, cwd=str(ROOT))
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout=120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"loadtest exited {proc.returncode}: {err.decode()[-500:]}")
    summary = json.loads(out.decode().strip().splitlines()[-1])
    if summary["errors"] or summary["requests"] <= 0:
        raise AssertionError(f"loadtest at {users} users: {summary}")
    return summary


async def load_curve(card, label: str, mode: str, port: int, load: dict, saturate: bool = True) -> dict:
    """1 user (latency), then, with ``saturate``, 8, 16 and 32 users until
    predictions/s stops rising by more than 10%: the last point that rose
    is the saturating one."""
    points = {1: await _load_point(port, 1, load)}
    print(f"[{card}] load {label} mode={mode} users=1 {json.dumps(points[1])}", flush=True)
    if not saturate:
        return {"users_1": points[1], "saturation": None}
    sat = None
    for users in LOAD_USERS:
        points[users] = await _load_point(port, users, load)
        print(f"[{card}] load {label} mode={mode} users={users} {json.dumps(points[users])}", flush=True)
        if sat is not None and points[users]["requests_per_sec"] <= LOAD_RISE * points[sat]["requests_per_sec"]:
            break
        sat = users
    return {"users_1": points[1], "saturation": {"users": sat, **points[sat]}}


async def serve_twins(card, path: Path, kernels: tuple = (), load: dict | None = None) -> dict:
    """One deployment served captured and as its eager twin: the runtimes
    held together (``check_twin_runtimes``), then, with ``load``, each
    server driven by the port's load generator (the captured one to its
    saturating point, the eager twin at 1 user, to keep the script's
    time); no new key on either after the traffic; the graph
    pool's bytes."""
    label = path.stem
    cap, build_s, cap_warm = await _start(path)
    eager, _, eager_warm = await _start(path, cuda_graphs=False)
    try:
        breakdown = check_twin_runtimes(card, label, cap, eager, kernels)
        curves = {}
        if load is not None:
            for mode, srv in (("captured", cap), ("eager", eager)):
                curves[mode] = await load_curve(card, label, mode, srv.port, load, saturate=mode == "captured")
    finally:
        await cap.stop()
        await eager.stop()
    recompiles = {f"{mode}/{node}": rt.recompiles_since_warmup() for mode, srv in (("captured", cap), ("eager", eager))
                  for node, rt in _runtimes(srv)}
    pool = {"captured": cap.warmup_reserved_bytes, "eager": eager.warmup_reserved_bytes}
    print(f"[{card}] twins {label}: warmup_s captured={cap_warm:.3f} eager={eager_warm:.3f} build_s={build_s:.3f} "
          f"warmup memory_reserved growth bytes {json.dumps(pool)} recompiles_since_warmup after the traffic "
          f"{json.dumps(recompiles)}", flush=True)
    if any(recompiles.values()):
        raise AssertionError(f"{label}: new keys after warmup: {recompiles}")
    summary = {"pool_bytes": pool, "breakdown": breakdown}
    if curves:
        summary["load"] = {mode: {"p50_ms_1_user": c["users_1"]["p50_ms"], "p99_ms_1_user": c["users_1"]["p99_ms"],
                                  **({} if c["saturation"] is None else {
                                      "saturating_users": c["saturation"]["users"],
                                      "predictions_per_s": c["saturation"]["requests_per_sec"],
                                      "p50_ms": c["saturation"]["p50_ms"], "p99_ms": c["saturation"]["p99_ms"]})}
                           for mode, c in curves.items()}
        print(f"[{card}] load {label} summary {json.dumps(summary['load'])}", flush=True)
    return summary


async def baseline_twins(card) -> dict:
    """Phase 4d: the five BASELINE deployments captured against their eager
    twins, and under load (JSON bodies; the ResNet ensemble uint8 npy, the
    wire it serves)."""
    loads = {
        "iris": {"payload": "json", "features": 4},
        "mnist": {"payload": "json", "features": 784},
        "iris_abtest": {"payload": "json", "features": 4},
        "resnet_ensemble": {"payload": "npy", "features": (224, 224, 3)},
        "full_dag_bert": {"payload": "json", "features": 128},
    }
    return {name: await serve_twins(card, BASELINE_DIR / f"{name}.json",
                                    ("flash_attention",) if name == "full_dag_bert" else (), load)
            for name, load in loads.items()}


# ------------------------------------------------------ phase 8: telemetry
# Every server of phases 3-7 runs with telemetry at its defaults (tracing,
# metrics and the flight recorder on). Phase 8 reads what it recorded:
# request traces, /metrics, the decode flight frames and the profiler,
# each check shown to fail on a planted fault, and prints the split of a
# served request, the decode round's host phases and telemetry's cost.
TRACE_REQUESTS = 50
TELEMETRY_LOAD_USERS = 16  # at or past the saturating point of iris and the DAG (PERF.md)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def metric_samples(text: str) -> dict:
    """Prometheus 0.0.4 text -> {(sample name, sorted label pairs): value}
    (the card's host has no prometheus_client to parse it)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        out[(name, tuple(sorted(_LABEL_RE.findall(labels))))] = float(value)
    return out


def metric_total(samples: dict, name: str, **labels) -> float:
    return sum(v for (n, ls), v in samples.items() if n == name and all((k, v2) in ls for k, v2 in labels.items()))


async def _get(port: int, path: str):
    status, _, body, _ = await _request(port, b"", path=path, method="GET")
    if status != 200:
        raise AssertionError(f"GET {path} answered {status}: {body[:300]!r}")
    return body


def _traceparent(name: str, i: int) -> tuple[str, str, str]:
    """Request ``i``'s header: a trace id of its own (fragments under one
    trace id merge in the store) and a caller's span id."""
    import zlib

    trace_id, parent = f"{zlib.crc32(name.encode()):08x}{i + 1:024x}", f"{0xa11ce + i:016x}"
    return f"00-{trace_id}-{parent}-01", trace_id, parent


def expected_calls(node, routing: dict) -> list:
    """The unit calls a request's walk makes, from the graph and its
    routing: ``name.method`` per call, in walk order."""
    from seldon_core_tpu_torch.engine.executor import _has_method
    from seldon_core_tpu_torch.graph.spec import PredictiveUnitMethod as M

    calls = []
    if _has_method(node, M.TRANSFORM_INPUT):
        calls.append(f"{node.name}.transform_input")
    if node.children:
        if _has_method(node, M.ROUTE):
            calls.append(f"{node.name}.route")
        branch = routing.get(node.name, -1)
        for c in (node.children if branch < 0 else [node.children[branch]]):
            calls += expected_calls(c, routing)
        if _has_method(node, M.AGGREGATE):
            calls.append(f"{node.name}.aggregate")
    if _has_method(node, M.TRANSFORM_OUTPUT):
        calls.append(f"{node.name}.transform_output")
    return calls


def check_trace(rec: dict, trace_id: str, parent: str, calls: list) -> dict:
    """A served request's span tree: an ingress root continuing the header
    (its trace id, parented to its span), one batcher child, one unit span
    per unit call under the batcher, every child inside its parent's
    interval. Returns the request's split in ms."""
    spans = rec["trace"]
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "ingress"]
    if rec["trace_id"] != trace_id or len(roots) != 1 or roots[0]["parent_id"] != parent:
        raise AssertionError(f"trace {rec['trace_id']}: want one ingress root continuing {trace_id}/{parent}")
    root = roots[0]
    batchers = [s for s in spans if s["name"] == "batcher"]
    if len(batchers) != 1 or batchers[0]["parent_id"] != root["span_id"]:
        raise AssertionError(f"trace {trace_id}: {len(batchers)} batcher spans, want one under the root")
    batcher = batchers[0]
    units = [s for s in spans if "unit" in s.get("attrs", {}) and "method" in s.get("attrs", {})]
    if sorted(s["name"] for s in units) != sorted(calls) or any(s["parent_id"] != batcher["span_id"] for s in units):
        raise AssertionError(f"trace {trace_id}: unit spans {[s['name'] for s in units]}, want {calls} under the "
                             f"batcher")
    if len(spans) != 2 + len(units):
        raise AssertionError(f"trace {trace_id}: {len(spans)} spans, want {2 + len(units)}")
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is not None and not (p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]):
            raise AssertionError(f"trace {trace_id}: span {s['name']} leaves its parent {p['name']}'s interval")
    children = sum(s["end_ns"] - s["start_ns"] for s in spans if s["parent_id"] == root["span_id"])
    return {"root_ms": root["ms"], "batcher_ms": batcher["ms"],
            "queue_wait_ms": batcher["attrs"]["queue_wait_ms"],
            "ingress_self_ms": (root["end_ns"] - root["start_ns"] - children) / 1e6,
            **{f"unit {s['name']}": s["ms"] for s in units}}


def check_delta(label: str, before: dict, after: dict, name: str, want: float, **labels) -> None:
    got = metric_total(after, name, **labels) - metric_total(before, name, **labels)
    if got != want:
        raise AssertionError(f"{label}: {name}{labels} moved by {got}, want {want}")


def check_flight(label: str, frames: list, tokens: int, requests: int) -> None:
    """The frames of a decode run total what was served: tokens, and one
    admission and one retirement per request."""
    got = (sum(f["tokens"] for f in frames), sum(f.get("admitted", 0) for f in frames),
           sum(f.get("retired", 0) for f in frames))
    if got != (tokens, requests, requests):
        raise AssertionError(f"{label}: flight frames total (tokens, admitted, retired) {got}, "
                             f"want {(tokens, requests, requests)}")


def must_fail(label: str, fn) -> None:
    """A planted fault: the check must raise."""
    try:
        fn()
    except AssertionError:
        return
    raise AssertionError(f"planted fault passed its check: {label}")


def _mean(rows: list) -> dict:
    """Per key, the mean over the rows that have it (a routed arm's span
    over the requests routed to it)."""
    keys = sorted({k for r in rows for k in r})
    return {k: round(sum(r[k] for r in rows if k in r) / sum(k in r for r in rows), 4) for k in keys}


async def serve_traces(card, name: str) -> dict:
    """Phase 8a: TRACE_REQUESTS one-row requests, each with its own
    traceparent header and the ``trace`` tag (a trace continuing a caller's
    header is kept only when flagged: the reference's tail sampling), one
    after another; each GET /traces/{puid} held by ``check_trace``;
    /metrics: the ingress count rises by the requests, each unit call's
    count by the requests that made it; on the DAG one feedback moves
    ``seldon_api_model_feedback``. Returns the mean split."""
    import numpy as np

    server, *_ = await _start(BASELINE_DIR / f"{name}.json")
    rt = _runtimes(server)[0][1]
    rng = np.random.default_rng(12)
    dep, pred = server.deployment_name, server.predictor.name
    splits, calls_made = [], {}
    try:
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        last = None
        for i in range(TRACE_REQUESTS):
            header, trace_id, parent = _traceparent(name, i)
            ids = rng.integers(0, rt.params["tok_emb"].shape[0], size=(1, rt.feature_shape[0]))
            body = {"meta": {"puid": f"{name}-trace-{i}", "tags": {"trace": 1}}, "data": {"ndarray": ids.tolist()}}
            status, _, out, client_ms = await _request(server.port, json.dumps(body).encode(),
                                                       headers={"traceparent": header})
            if status != 200:
                raise AssertionError(f"{name} traced request answered {status}: {out[:300]!r}")
            last = json.loads(out)
            calls = expected_calls(server.executor.root, last["meta"].get("routing", {}))
            for c in calls:
                calls_made[c] = calls_made.get(c, 0) + 1
            rec = json.loads(await _get(server.port, f"/traces/{name}-trace-{i}"))
            split = check_trace(rec, trace_id, parent, calls)
            # what the client waited beyond the root span: the HTTP parse,
            # the JSON codecs outside the service, the event loop's turns
            splits.append({**split, "client_ms": client_ms, "outside_root_ms": client_ms - split["root_ms"]})
        if name == "full_dag_bert":
            fb = json.dumps({"response": last, "reward": 1.0}).encode()
            status, _, out, _ = await _request(server.port, fb, path="/api/v0.1/feedback")
            if status != 200:
                raise AssertionError(f"feedback answered {status}: {out[:200]!r}")
        after = metric_samples((await _get(server.port, "/metrics")).decode())
        recompiles = {n: r.recompiles_since_warmup() for n, r in _runtimes(server)}
    finally:
        await server.stop()
    if any(recompiles.values()):
        raise AssertionError(f"{name}: new keys after warmup with telemetry on: {recompiles}")
    ingress = "seldon_api_ingress_server_requests_duration_seconds_count"
    unit = "seldon_api_engine_client_requests_duration_seconds_count"
    check_delta(name, before, after, ingress, TRACE_REQUESTS, deployment_name=dep, method="predict")
    for call, n in calls_made.items():
        node, method = call.rsplit(".", 1)
        check_delta(name, before, after, unit, n, deployment_name=dep, predictor_name=pred, model_name=node,
                    method=method)
    if name == "full_dag_bert":
        router = server.executor.root.children[0].name
        check_delta(name, before, after, "seldon_api_model_feedback_total", 1, model_name=router)
        check_delta(name, before, after, ingress, 1, method="feedback")
    # planted faults: a dropped span, a metric off by one
    rec = json.loads(json.dumps(rec))
    _, trace_id, parent = _traceparent(name, TRACE_REQUESTS - 1)
    for drop in ("batcher", calls[-1]):
        cut = dict(rec, trace=[s for s in rec["trace"] if s["name"] != drop])
        must_fail(f"{name}: trace without its {drop} span", lambda: check_trace(cut, trace_id, parent, calls))
    must_fail(f"{name}: ingress count off by one", lambda: check_delta(
        name, before, after, ingress, TRACE_REQUESTS + 1, deployment_name=dep, method="predict"))
    split = _mean(splits)
    print(f"[{card}] telemetry {name} bucket 1: {TRACE_REQUESTS} traces held (root continues the header, one "
          f"batcher, one span per unit call {sorted(calls_made)}, children inside parents); /metrics ingress "
          f"+{TRACE_REQUESTS}, unit calls {json.dumps(calls_made)}; mean split ms {json.dumps(split)}", flush=True)
    return split


async def telemetry_faults(card) -> dict:
    """Phase 8b: iris_fallback_breaker with a failing primary (phase 7's
    traffic, each request traced): retries equal the traces' retry events,
    injected faults the fault schedule's calls, one degraded response per
    request, the breaker open."""
    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults

    server, *_ = await _start(BASELINE_DIR / "iris_fallback_breaker.json")
    dep = server.deployment_name
    retry_events = 0
    try:
        sched = install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        for i in range(4):
            body = {"meta": {"puid": f"faults-{i}", "tags": {"trace": 1}}, "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}
            status, out, _ = await _post(server.port, json.dumps(body).encode())
            if status != 200 or out["meta"]["tags"].get("degraded") != "router_fallback":
                raise AssertionError(f"a failing primary was not served by the fallback: {status} {out}")
            rec = json.loads(await _get(server.port, f"/traces/faults-{i}"))
            retry_events += sum(e["name"] == "retry" for s in rec["trace"] for e in s.get("events", []))
        after = metric_samples((await _get(server.port, "/metrics")).decode())
        calls = sched["iris-primary"].calls
    finally:
        await server.stop()
    check_delta("faults", before, after, "seldon_tpu_retries_total", retry_events, deployment_name=dep,
                model_name="iris-primary")
    check_delta("faults", before, after, "seldon_tpu_faults_injected_total", calls, deployment_name=dep,
                model_name="iris-primary", kind="error")
    check_delta("faults", before, after, "seldon_tpu_degraded_responses_total", 4, deployment_name=dep,
                mode="router_fallback")
    check_delta("faults", before, after, "seldon_tpu_breaker_transitions_total", 1, deployment_name=dep,
                endpoint="iris-primary", state="open")
    state = metric_total(after, "seldon_tpu_breaker_state", deployment_name=dep, endpoint="iris-primary")
    if state != 2 or retry_events == 0:
        raise AssertionError(f"breaker state gauge {state} (want 2 = open), retry events {retry_events}")
    must_fail("faults: degraded off by one", lambda: check_delta(
        "faults", before, after, "seldon_tpu_degraded_responses_total", 5, deployment_name=dep,
        mode="router_fallback"))
    out = {"retries": retry_events, "faults": calls, "degraded": 4, "breaker_state": state}
    print(f"[{card}] telemetry faults iris_fallback_breaker: {json.dumps(out)}", flush=True)
    return out


def phase_split(frames: list) -> dict:
    """Per round, from /decode/flight frames: wall, busy and gap; enqueue and
    readback per family; the gap by phase, each as ms and as a share of the
    round's wall."""
    n = len(frames)
    fam = {}
    for f in frames:
        for k, v in f.get("busy_us", {}).items():
            fam.setdefault(k, [0.0, 0.0])[0] += v
        for k, v in f.get("rdb_us", {}).items():
            fam.setdefault(k, [0.0, 0.0])[1] += v
    busy = sum(v[0] for v in fam.values()) / n / 1e3
    gap = sum(f["gap_us"] for f in frames) / n / 1e3
    wall = busy + gap
    phases = {}
    for f in frames:
        for k, v in f.get("phase_us", {}).items():
            phases[k] = phases.get(k, 0.0) + v
    modes = {}
    for f in frames:
        modes[f["mode"]] = modes.get(f["mode"], 0) + 1
    return {
        "rounds": n, "modes": modes, "wall_ms": round(wall, 4), "busy_ms": round(busy, 4), "gap_ms": round(gap, 4),
        "families_ms": {k: {"enqueue": round((b - r) / n / 1e3, 4), "readback": round(r / n / 1e3, 4)}
                        for k, (b, r) in fam.items()},
        "phases_ms": {k: round(v / n / 1e3, 4) for k, v in sorted(phases.items(), key=lambda kv: -kv[1])},
        "phase_share_of_wall": {k: round(v / n / 1e3 / wall, 4) for k, v in phases.items()} if wall else {},
    }


async def _frames_of(port: int, name: str, since: int) -> list:
    rep = json.loads(await _get(port, "/decode/flight?n=4096"))["recorders"][name]
    return [f for f in rep["frames"] if f["seq"] >= since]


async def decode_phases(card, name: str, traffic, sched, port: int, dep: str) -> dict:
    """The round split of ``traffic`` with ENGINE_FLIGHT_SYNC_TIMING off,
    then on (a synchronize after every dispatch: each family's enqueue
    column is then the device's wall)."""
    out = {}
    for sync in (False, True):
        sched._sync_timing = sync
        since = sched.flight.rounds
        await traffic(port)
        out["sync_on" if sync else "sync_off"] = phase_split(await _frames_of(port, dep, since))
    sched._sync_timing = False
    print(f"[{card}] telemetry decode phases {name}: {json.dumps(out)}", flush=True)
    return out


async def step_hop(sched, reps: int = 50) -> dict:
    """With no traffic: one plain step called directly (``_step``: inputs
    uploaded, the replay, sampling, the readback), the same through the
    worker thread as a round calls it, and the worker hop alone — the
    median ms of each."""
    import numpy as np

    n = sched.n_slots
    z, pos = np.zeros(n, np.int32), np.full(n, sched.max_ctx - 1, np.int32)
    bt, zf = sched.pool.block_tables(), np.zeros(n, np.float32)

    def step():
        sched.pool.load_block_tables(bt)
        sched._step(z, pos, zf, z, 0)

    async def timed(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            await fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return round(sorted(times)[reps // 2], 4)

    async def direct():
        sched._on_worker(step)

    return {"direct": await timed(direct), "via_worker": await timed(lambda: sched._device_call(step)),
            "hop_only": await timed(lambda: sched._device_call(lambda: None))}


async def serve_decode_telemetry(card) -> dict:
    """Phase 8c: gpt_continuous_batching under phase 5's traffic (16
    staggered requests, mixed budgets): /decode/flight frames total the
    served tokens, admissions and retirements; /decode/health reads the
    bubble; /decode/profile has samples of the loop's thread (?hz=200);
    the round split with sync timing off and on; the step's wall with the
    recorder on and off, in turns. A copy with decode_slo_ttft_ms huge and
    decode_slo_itl_ms tiny: every TTFT meets its SLO and every later token
    breaches, on /metrics. Then gpt2_small_speculative's round split."""
    import numpy as np

    out = {}
    path = BASELINE_DIR / "gpt_continuous_batching.json"
    server, *_ = await _start(path)
    sched = server.decode_scheduler
    dep = server.deployment_name
    vocab = _model_runtime(server).params["tok_emb"].shape[0]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, vocab, size=(CB_REQUESTS, sched.seq_len))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=CB_REQUESTS)]

    async def traffic(port):
        async def one(i):
            await asyncio.sleep(0.004 * i)
            return await _ids_post(port, prompts[i : i + 1], {"max_new_tokens": budgets[i]})

        replies = await asyncio.gather(*(one(i) for i in range(CB_REQUESTS)))
        return _served_rows("gpt_continuous_batching telemetry", replies, budgets, sched.seq_len)

    try:
        prof = json.loads(await _get(server.port, "/decode/profile?hz=1000"))
        if prof["hz"] != 200:
            raise AssertionError(f"/decode/profile?hz=1000 set {prof['hz']} Hz, want the 200 Hz cap")
        await traffic(server.port)
        frames = await _frames_of(server.port, dep, 0)
        check_flight("gpt_continuous_batching", frames, sum(budgets), CB_REQUESTS)
        lost = json.loads(json.dumps(frames))
        next(f for f in lost if f["tokens"])["tokens"] -= 1
        must_fail("a frame that loses a token", lambda: check_flight("planted", lost, sum(budgets), CB_REQUESTS))
        health = json.loads(await _get(server.port, "/decode/health"))[dep]
        if not 0.0 < health["bubble_fraction"] < 1.0 or health["tokens"] != sum(budgets):
            raise AssertionError(f"/decode/health: {health}")
        prof = json.loads(await _get(server.port, "/decode/profile?n=8"))
        if prof["samples"] <= 0:
            raise AssertionError(f"/decode/profile sampled nothing: {prof}")
        out["health"] = {k: health[k] for k in ("bubble_fraction", "top_gap_phase", "phase_of_gap", "rounds")}
        out["profile"] = {"samples": prof["samples"], "top": prof["top"][:5]}
        out["phases"] = await decode_phases(card, "gpt_continuous_batching", traffic, sched, server.port, dep)
        walls = {"on": [], "off": []}
        for on in (True, False, False, True):
            sched.flight.enabled = sched._phases.enabled = on
            steps = sched.stat_steps
            t0 = time.perf_counter()
            await traffic(server.port)
            walls["on" if on else "off"].append(round((time.perf_counter() - t0) * 1e3 / (sched.stat_steps - steps), 4))
        sched.flight.enabled = sched._phases.enabled = True
        out["step_wall_ms_flight"] = walls
        out["idle_step_ms"] = await step_hop(sched)
        await _get(server.port, "/decode/profile?hz=19")  # back to the default rate
        if sched.recompiles_since_warmup() != 0:
            raise AssertionError("gpt_continuous_batching built new keys with telemetry on")
    finally:
        await server.stop()

    server, *_ = await _start(_deployment_copy("gpt_continuous_batching",
                                               {"decode_slo_ttft_ms": 1e6, "decode_slo_itl_ms": 1e-3}))
    try:
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        rows = await traffic(server.port)
        after = metric_samples((await _get(server.port, "/metrics")).decode())
    finally:
        await server.stop()
    slo = "seldon_tpu_decode_slo_attainment_total"
    sdep = server.deployment_name
    check_delta("slo", before, after, slo, CB_REQUESTS, deployment_name=sdep, kind="ttft", outcome="ok")
    check_delta("slo", before, after, slo, sum(budgets) - CB_REQUESTS, deployment_name=sdep, kind="itl",
                outcome="breach")
    check_delta("slo", before, after, slo, 0, deployment_name=sdep, kind="ttft", outcome="breach")
    must_fail("slo: itl breaches off by one", lambda: check_delta(
        "slo", before, after, slo, sum(budgets) - CB_REQUESTS + 1, deployment_name=sdep, kind="itl",
        outcome="breach"))
    out["slo"] = {"ttft_ok": CB_REQUESTS, "itl_breach": sum(budgets) - CB_REQUESTS, "rows": len(rows)}

    path = BASELINE_DIR / "gpt2_small_speculative.json"
    server, *_ = await _start(path)
    sched = server.decode_scheduler
    prompts_s, budgets_s = _spec_prompts(sched, _model_runtime(server).params["tok_emb"].shape[0])

    async def spec_traffic(port):
        replies, _ = await _spec_traffic(port, prompts_s, budgets_s)
        return _served_rows("gpt2_small_speculative telemetry", replies, budgets_s, sched.seq_len)

    try:
        await spec_traffic(server.port)  # the controller settles
        out["spec_phases"] = await decode_phases(card, "gpt2_small_speculative", spec_traffic, sched, server.port,
                                                 server.deployment_name)
        if sched.recompiles_since_warmup() != 0:
            raise AssertionError("gpt2_small_speculative built new keys with telemetry on")
    finally:
        await server.stop()
    keys = ("health", "profile", "slo", "step_wall_ms_flight", "idle_step_ms")
    print(f"[{card}] telemetry decode: {json.dumps({k: out[k] for k in keys})}", flush=True)
    return out


async def telemetry_cost(card) -> dict:
    """Phase 8d: telemetry on (the defaults) against off (the tracer
    disabled, metrics_enabled=False) under the load generator at
    TELEMETRY_LOAD_USERS users, in turns (on, off, off, on): iris
    (ingress-bound) and the BERT DAG."""
    from seldon_core_tpu_torch.telemetry import Tracer

    loads = {"iris": {"payload": "json", "features": 4}, "full_dag_bert": {"payload": "json", "features": 128}}
    out = {}
    for name, load in loads.items():
        on, *_ = await _start(BASELINE_DIR / f"{name}.json")
        off, *_ = await _start(BASELINE_DIR / f"{name}.json", metrics_enabled=False)
        off.service.tracer = Tracer(enabled=False)
        runs = {"on": [], "off": []}
        try:
            for mode, srv in (("on", on), ("off", off), ("off", off), ("on", on)):
                pt = await _load_point(srv.port, TELEMETRY_LOAD_USERS, load)
                runs[mode].append({k: pt[k] for k in ("requests_per_sec", "p50_ms", "p99_ms")})
        finally:
            await on.stop()
            await off.stop()
        if off.metrics.export() != b"":
            raise AssertionError(f"{name}: the telemetry-off server exported metrics")
        spread = {m: round(max(r["requests_per_sec"] for r in rs) / min(r["requests_per_sec"] for r in rs), 3)
                  for m, rs in runs.items()}
        out[name] = {**runs, "spread": spread}
        print(f"[{card}] telemetry cost {name} users={TELEMETRY_LOAD_USERS}: {json.dumps(out[name])}", flush=True)
    return out


async def serve_telemetry(card) -> dict:
    """Phase 8, every part in one event loop."""
    out = {"split": {}}
    for name in ("bert_base_flash", "full_dag_bert"):
        out["split"][name] = await serve_traces(card, name)
    out["faults"] = await telemetry_faults(card)
    out["decode"] = await serve_decode_telemetry(card)
    out["cost"] = await telemetry_cost(card)
    return out


# Phase 9: the pipelined rounds against the serial loop, and the host and
# store KV tiers. Both loops are served by one server per deployment, in
# turns (pipelined, serial, serial, pipelined): the scheduler's
# ``pipeline_enabled`` is what ENGINE_DECODE_PIPELINE=off sets at build.
LOOPS = ("pipelined", "serial", "serial", "pipelined")
TIER_MAX_NEW = 8  # generated tokens per tier request: the prefix is what is held
IDLE_REPS = 50


def round_numbers(frames: list) -> dict:
    """``phase_split`` of a run's frames, the mean overlap per round (ms)
    and how many rounds ran a window."""
    out = phase_split(frames)
    out["overlap_ms"] = round(sum(f.get("overlap_us", 0.0) for f in frames) / len(frames) / 1e3, 4)
    out["overlap_rounds"] = sum(1 for f in frames if f.get("overlap_us"))
    out["step_rounds"] = sum(1 for f in frames if f["mode"] != "chunk")
    return out


async def _cb_traffic(port: int, prompts, budgets, tags: dict | None = None, stagger: float = 0.004):
    """Phase 5's traffic: staggered requests with their own budgets."""
    async def one(i):
        await asyncio.sleep(stagger * i)
        return await _ids_post(port, prompts[i : i + 1], {"max_new_tokens": budgets[i], **(tags or {})})

    t0 = time.perf_counter()
    replies = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    return replies, time.perf_counter() - t0


async def loops_in_turns(card, label: str, server, traffic, budgets) -> tuple[list, dict]:
    """``traffic`` on the pipelined and the serial loop in turns: the rows
    of each run (bit for bit between the loops and between runs of one
    loop), and per loop and run the round numbers from the flight frames
    and tokens/s. A pipelined run must run a window in every step round
    (``stat_pipelined_rounds`` counts them) and show overlap; a serial run
    none."""
    sched = server.decode_scheduler
    rows, numbers = {}, {"pipelined": [], "serial": []}
    for loop in LOOPS:
        sched.pipeline_enabled = loop == "pipelined"
        since, windows = sched.flight.rounds, sched.stat_pipelined_rounds
        replies, wall = await traffic(server.port)
        run_rows = _served_rows(f"{label} {loop}", replies, budgets, sched.seq_len)
        ref = rows.setdefault(loop, run_rows)
        if any((a != b).any() for a, b in zip(run_rows, ref)):
            raise AssertionError(f"{label}: two {loop} runs of the same traffic served different ids")
        n = round_numbers(await _frames_of(server.port, server.deployment_name, since))
        n["pipelined_rounds"] = sched.stat_pipelined_rounds - windows
        n["tokens_per_s"] = round(sum(budgets) / wall, 2)
        numbers[loop].append(n)
        want = n["step_rounds"] if loop == "pipelined" else 0
        if n["pipelined_rounds"] != want or (loop == "pipelined") != (n["overlap_rounds"] > 0):
            raise AssertionError(f"{label} {loop}: {n['pipelined_rounds']} windows and {n['overlap_rounds']} rounds "
                                 f"with overlap over {n['step_rounds']} step rounds")
    sched.pipeline_enabled = True
    differ = [r for r, (a, b) in enumerate(zip(rows["pipelined"], rows["serial"])) if (a != b).any()]
    if differ:
        raise AssertionError(f"{label}: pipelined rows {differ} differ from the serial loop's")
    print(f"[{card}] pipeline {label}: {json.dumps(numbers)}", flush=True)
    return rows["pipelined"], numbers


async def readback_waits_in_turns(card, label: str, server, traffic, budgets, rows) -> dict:
    """The pipelined loop under ``traffic`` with its readback polled on the
    loop's thread within ``readback_spin_s`` (the default), handed to the
    worker at once (the bound 0: the event's synchronize() there) and
    polled to the end (no bound), in turns: every run's rows bit for bit
    ``rows``; per mode and run the round numbers, tokens/s and the waits
    handed to the worker."""
    sched = server.decode_scheduler
    spin = sched.readback_spin_s
    bounds = {"bounded_poll": spin, "worker_sync": 0.0, "poll": float("inf")}
    numbers = {mode: [] for mode in bounds}
    for mode in ("bounded_poll", "worker_sync", "poll", "poll", "worker_sync", "bounded_poll"):
        sched.readback_spin_s = bounds[mode]
        since, handoffs = sched.flight.rounds, sched.stat_readback_handoffs
        replies, wall = await traffic(server.port)
        got = _served_rows(f"{label} {mode}", replies, budgets, sched.seq_len)
        if any((a != b).any() for a, b in zip(got, rows)):
            raise AssertionError(f"{label}: the {mode} readback wait served other ids than the loops' runs")
        n = round_numbers(await _frames_of(server.port, server.deployment_name, since))
        n["handoffs"] = sched.stat_readback_handoffs - handoffs
        n["tokens_per_s"] = round(sum(budgets) / wall, 2)
        numbers[mode].append(n)
    sched.readback_spin_s = spin
    print(f"[{card}] readback wait {label} (bound {spin * 1e3} ms): {json.dumps(numbers)}", flush=True)
    return numbers


async def idle_step(sched, reps: int = IDLE_REPS) -> dict:
    """With no traffic, the median ms of one plain step (inputs, replay,
    sampling, readback): through the worker as the serial loop runs it;
    queued from the loop's thread and awaited by polling its event, as the
    pipelined loop runs it; queued from the loop's thread and awaited by
    the event's synchronize() on the worker; and the worker hop alone."""
    import numpy as np
    import torch

    n = sched.n_slots
    z, pos = np.zeros(n, np.int32), np.full(n, sched.max_ctx - 1, np.int32)
    bt, zf = sched.pool.block_tables(), np.zeros(n, np.float32)

    def step():
        sched.pool.load_block_tables(bt)
        sched._step(z, pos, zf, z, 0)

    def enqueue():
        with sched._on_stream(), torch.inference_mode():
            sched.pool.load_block_tables(bt)
            return sched._readback_async(sched._step_enqueue(z, pos, zf, z, 0))

    async def poll():
        await sched._await_readback(*enqueue())

    async def sync_on_worker():
        host, done = enqueue()
        if done is not None:
            await sched._device_call(done.synchronize)
        host.numpy().copy()

    async def timed(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            await fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return round(sorted(times)[reps // 2], 4)

    return {"via_worker": await timed(lambda: sched._device_call(step)), "loop_poll": await timed(poll),
            "loop_event_sync_on_worker": await timed(sync_on_worker),
            "hop_only": await timed(lambda: sched._device_call(lambda: None))}


async def rollback_run(sched, prompts) -> dict:
    """F generates; at F's first overlap window P arrives (so the window
    decides it), P's caller leaves while the step is in flight (its task
    cancelled), and Q arrives after the window, to be admitted by the
    serial walk into the slot P's decision held. Returns F's and Q's rows
    and the counters' deltas."""
    real, loop, tasks = sched._overlap_window, asyncio.get_running_loop(), {}

    def window():
        if "p" in tasks or not sched.active or sched._waiting:
            return real()
        tasks["p"] = asyncio.Task(sched.submit(prompts[1], max_new_tokens=4), loop=loop, eager_start=True)
        real()
        tasks["p"].cancel()  # the caller leaves during the flight
        tasks["q"] = asyncio.Task(sched.submit(prompts[2], max_new_tokens=4), loop=loop, eager_start=True)

    keys = ("stat_pipeline_rollbacks", "stat_admitted", "stat_pipeline_admits")
    before = {k: getattr(sched, k) for k in keys}
    sched._overlap_window = window
    try:
        f = await sched.submit(prompts[0], max_new_tokens=8)
        q = await tasks["q"]
    finally:
        del sched._overlap_window
    with contextlib.suppress(asyncio.CancelledError):
        await tasks["p"]
    return {"f": f, "q": q, **{k: getattr(sched, k) - before[k] for k in keys}}


def check_rollback(run: dict) -> None:
    """The decision whose caller left was rolled back, never installed: one
    rollback, and only F and Q were admitted."""
    if (run["stat_pipeline_rollbacks"], run["stat_admitted"]) != (1, 2):
        raise AssertionError(f"a decision whose caller left in flight: {run['stat_pipeline_rollbacks']} rollbacks "
                             f"and {run['stat_admitted']} admissions, want 1 and 2")


def check_rollback_rows(run: dict, want, params, seq: int) -> None:
    """F's and Q's ids against the fused generate (tie rule, float32)."""
    _hold_ids("rollback run", [run["f"], run["q"]], [want[0][: seq + 8], want[2][: seq + 4]], params, seq,
              "float32")


async def pipeline_faults(card, sched, runtime, prompts) -> dict:
    """The rollback and the stale-plan guard on the live scheduler, then two
    planted faults on the same traffic, each of which must fail its check:
    an overlap admission installed before the readback walk (the rollback
    check), a chunk plan taken with a stale key (Q served P's prompt)."""
    seq = sched.seq_len
    want = _fused_oracle(runtime, prompts[:3])
    run = await rollback_run(sched, prompts)
    check_rollback(run)
    check_rollback_rows(run, want, runtime.params, seq)
    out = {"rollback": {k: v for k, v in run.items() if k.startswith("stat_")}}
    real_admit = sched._pipeline_admit

    def install_now():
        real_admit()
        sched._apply_pending()  # the fault: installed under the flight

    def take_any(key):
        plan, sched._pending_chunk_plan = sched._pending_chunk_plan, None
        return plan  # the fault: no key check

    for name, attr, fn, check in (
        ("admission_installed_before_the_walk", "_pipeline_admit", install_now, lambda r: check_rollback(r)),
        ("chunk_plan_with_a_stale_key", "_pipeline_take_chunk_plan", take_any,
         lambda r: check_rollback_rows(r, want, runtime.params, seq)),
    ):
        with planted(sched, attr, fn):
            r = await rollback_run(sched, prompts)
        delattr(sched, attr)
        must_fail(name, lambda: check(r))
        out[name] = {k: v for k, v in r.items() if k.startswith("stat_")}
        print(f"[{card}] planted fault {name}: failed its check ({json.dumps(out[name])})", flush=True)
    return out


async def serve_pipeline(card) -> dict:
    """Phase 9a: gpt_continuous_batching under phase 5's traffic and the
    GPT-2-small speculative deployment, its tree copy and its copy with
    speculation off under phase 6's, each on both loops in turns; greedy
    rows bit for bit between the loops and held to the fused generate; a
    sampled run (all requests at once, so both loops admit them in one
    round) identical between the loops; the idle step on both dispatch
    paths; a rollback and a deferral provoked; two planted faults."""
    import numpy as np

    out = {}
    path = BASELINE_DIR / "gpt_continuous_batching.json"
    server, *_ = await _start(path)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, vocab, size=(CB_REQUESTS, seq))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=CB_REQUESTS)]
    try:
        rows, loops = await loops_in_turns(card, "gpt_continuous_batching", server,
                                           lambda port: _cb_traffic(port, prompts, budgets), budgets)
        ties = _hold_ids("gpt_continuous_batching pipelined", rows, _fused_oracle(runtime, prompts), runtime.params,
                         seq, "float32")
        out["gpt_continuous_batching"] = {
            "loops": loops, "tie_rows": ties, "idle_step_ms": await idle_step(sched),
            "readback_waits": await readback_waits_in_turns(card, "gpt_continuous_batching", server,
                                                            lambda port: _cb_traffic(port, prompts, budgets),
                                                            budgets, rows)}
        out["faults"] = await pipeline_faults(card, sched, runtime, prompts)
        recompiles = sched.recompiles_since_warmup()
    finally:
        await server.stop()
    # a pool that holds two slots' worst case: heads the window tries defer
    server, *_ = await _start(_deployment_copy("gpt_continuous_batching", {"decode_kv_pages": 14}))
    tight = server.decode_scheduler
    try:
        replies, _ = await _cb_traffic(server.port, prompts, budgets)
        ties = _hold_ids("tight pool", _served_rows("tight pool", replies, budgets, seq),
                         _fused_oracle(_model_runtime(server), prompts), _model_runtime(server).params, seq,
                         "float32")
        tight.pool.alloc.check()
        out["tight_pool"] = {"deferred": tight.stat_pipeline_deferred, "blocked_rounds": tight.stat_admit_blocked_rounds,
                             "tie_rows": ties}
        recompiles = (recompiles, tight.recompiles_since_warmup())
    finally:
        await server.stop()
    if tight.stat_pipeline_deferred < 1:
        raise AssertionError(f"the tight pool deferred no head under a flight: {out['tight_pool']}")
    spec = BASELINE_DIR / "gpt2_small_speculative.json"
    for name, path in (("gpt2_small_speculative", spec),
                       ("gpt2_small_speculative_tree", _deployment_copy("gpt2_small_speculative",
                                                                        {"decode_spec_tree": "2,2,1,1"})),
                       ("gpt2_small_speculative_plain", _deployment_copy("gpt2_small_speculative", SPEC_OFF)),
                       ("gpt2_small_feature_draft", BASELINE_DIR / "gpt2_small_feature_draft.json")):
        server, *_ = await _start(path)
        sched, runtime = server.decode_scheduler, _model_runtime(server)
        seq_s = sched.seq_len
        prompts_s, budgets_s = _spec_prompts(sched, runtime.params["tok_emb"].shape[0])
        try:
            rows, loops = await loops_in_turns(card, name, server,
                                               lambda port: _spec_traffic(port, prompts_s, budgets_s), budgets_s)
            ties = _hold_ids(f"{name} pipelined", rows, _fused_oracle(runtime, prompts_s), runtime.params, seq_s,
                             "bfloat16")
            out[name] = {"loops": loops, "tie_rows": ties}
            if name == "gpt2_small_speculative":
                out[name]["readback_waits"] = await readback_waits_in_turns(
                    card, name, server, lambda port: _spec_traffic(port, prompts_s, budgets_s), budgets_s, rows)
                # sampled rows: every request at once (a slot each), the
                # deployment's fixed decode_seed, both loops
                sampled = {}
                n = sched.n_slots
                # the prefix index first holds these prompts (one entry each,
                # its cap), so both runs reuse the same spans
                await asyncio.gather(*(sched.submit(prompts_s[i], max_new_tokens=1) for i in range(n)))
                eager, tick = sched.stat_eager_rounds, sched._tick
                for loop in ("pipelined", "serial"):
                    sched.pipeline_enabled = loop == "pipelined"
                    # a slot's draws are per (seed, tick, stream) and its row:
                    # both runs start at one tick with the slots in one order
                    sched._tick, sched._free = tick, list(range(n - 1, -1, -1))
                    # through the scheduler's entry: requests through the
                    # ingress reach it in as many turns of the loop as
                    # their connections take
                    sampled[loop] = await asyncio.gather(*(sched.submit(prompts_s[i], temperature=0.8, top_k=40,
                                                                        max_new_tokens=16) for i in range(n)))
                sched.pipeline_enabled = True
                if any((a != b).any() for a, b in zip(sampled["pipelined"], sampled["serial"])):
                    raise AssertionError(f"{name}: sampled rows differ between the loops")
                out[name]["sampled"] = {"rows": n, "eager_rounds": sched.stat_eager_rounds - eager}
                if sched.stat_eager_rounds == eager:
                    raise AssertionError(f"{name}: the sampled run ran no eager round")
            if sched.feature_draft:
                out[name]["spec"] = {k: getattr(sched, f"stat_spec_{k}") for k in ("dispatches", "proposed",
                                                                                    "accepted", "emitted")}
            out[name]["recompiles"] = sched.recompiles_since_warmup()
            out[name]["pipeline_stats"] = pipeline_stats(sched)
        finally:
            await server.stop()
        if out[name]["recompiles"] != 0:
            raise AssertionError(f"{name}: new keys after warmup: {out[name]['recompiles']}")
    if recompiles != (0, 0):
        raise AssertionError(f"gpt_continuous_batching (and its tight copy) built new keys after warmup: {recompiles}")
    return out


def pipeline_stats(sched) -> dict:
    return {k: getattr(sched, f"stat_{k}") for k in ("pipelined_rounds", "pipeline_admits", "pipeline_deferred",
                                                     "pipeline_rollbacks", "pipeline_plans_used",
                                                     "readback_handoffs")}


def record_promotions(sched) -> list:
    """Keep (tokens, components) of every entry the scheduler promotes."""
    promoted, real = [], sched._install_promoted

    def install(tokens, comps):
        promoted.append((tokens, comps))
        return real(tokens, comps)

    sched._install_promoted = install
    return promoted


def check_promoted_bytes(sched, prompt, promoted: list) -> None:
    """The prefix entry that serves ``prompt`` holds, page for page, the
    bytes of the last entry promoted (read back from the card)."""
    import numpy as np

    entry, depth = sched._prefix_index.match(prompt, touch=False)
    tokens, comps = promoted[-1]
    if entry is None or len(tokens) != len(entry.tokens) or (np.asarray(tokens) != entry.tokens).any():
        raise AssertionError(f"the prompt's device entry ({depth} deep) is not the last promoted one")
    with sched._on_stream():
        got = sched.pool.read_pages(entry.pages)
    bad = [i for i, (a, b) in enumerate(zip(got, comps)) if not np.array_equal(a, b[:, : a.shape[1]])]
    if bad:
        raise AssertionError(f"promoted pages differ from the tier's bytes in components {bad}")


def device_entry_bytes(sched, prompt) -> list:
    """The bytes of the device prefix entry that serves ``prompt``, read
    back from the card page for page (``read_pages``' layout)."""
    entry, depth = sched._prefix_index.match(prompt, touch=False)
    if entry is None:
        raise AssertionError(f"no device entry serves the prompt ({depth} deep)")
    with sched._on_stream():
        return sched.pool.read_pages(entry.pages)


def check_tier_bytes(label: str, warm: list, comps: list) -> None:
    """A tier's components for an entry hold, page for page, the bytes its
    pages held on the card while it was warm there: the demotion's
    readback, the host entry and the store's pickle, end to end."""
    import numpy as np

    bad = [i for i, (a, b) in enumerate(zip(warm, comps)) if not np.array_equal(a, np.asarray(b)[:, : a.shape[1]])]
    if len(warm) != len(comps) or bad:
        raise AssertionError(f"{label}: the tier's bytes differ from the device-warm entry's in components {bad}")


async def _tier_request(server, prompt, tags: dict | None = None):
    import numpy as np

    status, _, body, ms = await _ids_post(server.port, prompt[None], {"max_new_tokens": TIER_MAX_NEW, **(tags or {})})
    if status != 200:
        raise AssertionError(f"tier request returned HTTP {status}: {body[:300]!r}")
    return np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0][: len(prompt) + TIER_MAX_NEW], ms


def _in_window(sched, fn) -> None:
    """Run ``fn`` (it submits) at the start of the next overlap window."""
    real = sched._overlap_window

    def window():
        del sched._overlap_window
        fn()
        real()

    sched._overlap_window = window


async def serve_kv_tiers(card) -> dict:
    """Phase 9b: gpt2_small_kv_tier (GPT-2-small widths, bf16, a page budget
    below its prefixes, the host tier and a file store in a temp dir)
    through REST. A prompt A served cold, warm from the device, then (its
    entry pushed out of the index's LRU cap) promoted from host, then
    (pushed out of host too) promoted from the store: each warm row bit for
    bit the device-warm row and held to the cold one under the tie rule,
    each promoted entry's pages the tier's bytes. A promotion inside an
    overlap window (D), bit for bit D's device-warm row. The bytes a
    promotion installs are the tier's, and the tier's are the bytes the
    entry held on the card while warm (A from host and from the store, D).
    A corrupt store entry degrading to a cold prefill; a promotion written
    one page off and a demotion read one page off must each fail its byte
    check; the promotion's wall per page against the cold prefill's. Then
    an int8 copy of tiny_gpt_paged_kv held to its own cold output."""
    import tempfile

    import numpy as np
    import torch

    out = {}
    store_dir = tempfile.mkdtemp(prefix="kv-tier-store-")
    server, build_s, warmup_s = await _start(_deployment_copy("gpt2_small_kv_tier",
                                                              {"decode_kv_store_tier": f"file://{store_dir}"}))
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    tier, seq = sched._host_tier, sched.seq_len
    vocab = runtime.params["tok_emb"].shape[0]
    promoted = record_promotions(sched)
    entry_bytes = sum(a[:, :1].numel() * a.element_size() for a in sched.pool.state) * sched.pool.alloc.pages_for(seq)
    host_entries = tier.budget_bytes // entry_bytes
    cap = sched.prefix_slots
    prompts = np.random.default_rng(10).integers(0, vocab, size=(4 + 2 * cap + host_entries, seq))
    a = prompts[0]
    fill = iter(prompts[1:])
    # per filler prompt: its cold row, its device-warm row and the bytes of
    # its device entry while warm
    cold_rows, warm_rows, warm_bytes = {}, {}, {}

    async def serve_fill():
        p = next(fill)
        cold_rows[p.tobytes()] = (p, (await _tier_request(server, p))[0])
        warm_rows[p.tobytes()] = (await _tier_request(server, p))[0]
        warm_bytes[p.tobytes()] = device_entry_bytes(sched, p)

    try:
        cold, cold_ms = await _tier_request(server, a)
        warm_dev, dev_ms = await _tier_request(server, a)
        if sched.stat_prefix_hits != 1:
            raise AssertionError(f"the repeat of A missed the device index ({sched.stat_prefix_hits} hits)")
        a_bytes = device_entry_bytes(sched, a)
        for _ in range(cap):  # A leaves the index (LRU cap): demoted to host
            await serve_fill()
        if sched._prefix_index.match(a, touch=False)[1] or tier.probe(a, include_store=False) < seq:
            raise AssertionError("A was not demoted to host by the index's cap")
        host_before = tier.stat_promotions_host
        warm_host, host_ms = await _tier_request(server, a)
        if tier.stat_promotions_host != host_before + 1:
            raise AssertionError("A was not promoted from host")
        check_promoted_bytes(sched, a, promoted)
        check_tier_bytes("A from host", a_bytes, promoted[-1][1])
        for _ in range(cap + host_entries + 1):  # A leaves the index, then host: spilled to the store
            await serve_fill()
        if sched._prefix_index.match(a, touch=False)[1] or tier.probe(a, include_store=False) or tier.probe(a) < seq:
            raise AssertionError("A is not in the store alone")
        store_before = tier.stat_promotions_store
        warm_store, store_ms = await _tier_request(server, a)
        if tier.stat_promotions_store != store_before + 1:
            raise AssertionError("A was not promoted from the store")
        check_promoted_bytes(sched, a, promoted)
        check_tier_bytes("A from the store", a_bytes, promoted[-1][1])
        for label, row in (("host", warm_host), ("store", warm_store)):
            if (row != warm_dev).any():
                raise AssertionError(f"A promoted from {label} served other ids than A warm from the device")
        ties = _hold_ids("A warm vs cold", [warm_dev], [cold], runtime.params, seq, "bfloat16")
        out["a"] = {"warm_equals_cold": bool((warm_dev == cold).all()), "tie_rows": ties,
                    "latency_ms": {"cold": cold_ms, "device": dev_ms, "host": host_ms, "store": store_ms}}
        # a promotion inside an overlap window: D (in host, off the device)
        # arrives while F's step is in flight
        d = next(p for p, _ in cold_rows.values()
                 if tier.probe(p, include_store=False) >= seq and not sched._prefix_index.match(p, touch=False)[1])
        overlap_before, tasks = sched.stat_tier_promote_overlap, []
        _in_window(sched, lambda: tasks.append(asyncio.Task(
            sched.submit(d, max_new_tokens=TIER_MAX_NEW), loop=asyncio.get_running_loop(), eager_start=True)))
        await sched.submit(next(fill), max_new_tokens=TIER_MAX_NEW)
        d_row = await tasks[0]
        if sched.stat_tier_promote_overlap != overlap_before + 1:
            raise AssertionError("D was not promoted inside the overlap window")
        check_promoted_bytes(sched, d, promoted)
        check_tier_bytes("D from host", warm_bytes[d.tobytes()], promoted[-1][1])
        if (d_row != warm_rows[d.tobytes()]).any():
            raise AssertionError("D promoted in a window served other ids than D warm from the device")
        out["d"] = {"warm_equals_device_warm": True,
                    "tie_rows": _hold_ids("D promoted in a window vs cold", [d_row], [cold_rows[d.tobytes()][1]],
                                          runtime.params, seq, "bfloat16")}
        # a corrupt store entry: the request degrades to a cold prefill
        e = next(p for p, _ in cold_rows.values()
                 if tier.probe(p) >= seq and not tier.probe(p, include_store=False)
                 and not sched._prefix_index.match(p, touch=False)[1])
        key = tier._best_store_key(tuple(int(t) for t in e))
        tier.store.save(tier._store_index[key][0], b"not a pickle")
        drops, promos = tier.stat_store_drops, sched.stat_tier_promotions
        e_row, _ = await _tier_request(server, e)
        if tier.stat_store_drops != drops + 1 or sched.stat_tier_promotions != promos:
            raise AssertionError("the corrupt store entry was not dropped, or was promoted")
        if (e_row != cold_rows[e.tobytes()][1]).any():
            raise AssertionError("the request behind a corrupt store entry served other ids than its cold prefill")
        # timings, idle: one entry's pages written from host memory against
        # the chunk rounds that compute the same prefix cold
        g = next(p for p, _ in cold_rows.values()
                 if tier.probe(p, include_store=False) >= seq and not sched._prefix_index.match(p, touch=False)[1])
        comps = tier._best_host(tuple(int(t) for t in g)).components
        n_pages = sched.pool.alloc.pages_for(seq)
        pin = sched.pool.alloc.preseed_pin(n_pages)
        chunk = sched.prefill_chunk or seq
        z = np.zeros(sched.n_slots, np.int32)
        counts = z.copy()
        counts[0] = chunk
        ids = np.zeros((sched.n_slots, chunk), np.int32)

        def promote():
            with sched._on_stream():
                sched.pool.write_pages(pin.pages, [c[:, :n_pages] for c in comps])
            if sched._stream is not None:
                sched._stream.synchronize()

        def prefill():
            with sched._on_stream(), torch.inference_mode():
                sched.pool.load_block_tables(sched.pool.block_tables())  # every write to junk page 0
                for start in range(0, seq, chunk):
                    sched._chunk(ids, np.full(sched.n_slots, start, np.int32), counts, z.astype(np.float32), z, 0)

        promote_ms, prefill_ms = wall_ms(promote, 10), wall_ms(prefill, 10)
        sched.pool.alloc.release(pin.pin_id)
        out["timing"] = {"promote_ms_per_page": promote_ms / n_pages, "cold_prefill_ms_per_page": prefill_ms / n_pages,
                         "pages": n_pages}
        # planted: a promotion that writes each page's bytes one page off
        real_write = sched.pool.write_pages

        def one_page_off(pages, cols):
            real_write(list(pages[1:]) + list(pages[:1]), cols)

        with planted(sched.pool, "write_pages", one_page_off):
            g_row, _ = await _tier_request(server, g)
        delattr(sched.pool, "write_pages")
        must_fail("a promotion one page off", lambda: check_promoted_bytes(sched, g, promoted))
        g_ids_failed = bool((g_row != cold_rows[g.tobytes()][1]).any())
        print(f"[{card}] planted fault promotion_one_page_off: failed the byte check; ids "
              f"{'differ from' if g_ids_failed else 'equal'} the cold row", flush=True)
        # planted: a demotion that reads each page's bytes one page off, of
        # an entry warm on the device and not in host
        h = next(p for p, _ in reversed(list(cold_rows.values()))
                 if sched._prefix_index.match(p, touch=False)[0] is not None and not tier.probe(p, include_store=False))
        h_entry, _ = sched._prefix_index.match(h, touch=False)
        real_read = sched.pool.read_pages

        def read_one_off(pages):
            return real_read(list(pages[1:]) + list(pages[:1]))

        with planted(sched.pool, "read_pages", read_one_off):
            sched._demote_entry(h_entry)
        delattr(sched.pool, "read_pages")
        h_comps = tier._best_host(tuple(int(t) for t in h_entry.tokens)).components
        must_fail("a demotion one page off",
                  lambda: check_tier_bytes("H demoted one page off", warm_bytes[h.tobytes()], h_comps))
        print(f"[{card}] planted fault demotion_one_page_off: failed the tier byte check", flush=True)
        out["stats"] = {"tier": tier.snapshot(), "demotions": sched.stat_tier_demotions,
                        "promotions": sched.stat_tier_promotions,
                        "promote_overlap": sched.stat_tier_promote_overlap,
                        "demote_overlap": sched.stat_tier_demote_overlap,
                        "demote_overlap_ms": sched.stat_tier_demote_overlap_ns / 1e6,
                        "pipeline": pipeline_stats(sched), "build_s": build_s, "warmup_s": warmup_s,
                        "entry_bytes": entry_bytes, "host_entries": host_entries}
        if sched.recompiles_since_warmup() != 0:
            raise AssertionError(f"gpt2_small_kv_tier built new keys after warmup: {sched.compile_counts()}")
    finally:
        await server.stop()
    # int8 pages: A warm from host equals A's own cold output
    server, *_ = await _start(_deployment_copy("tiny_gpt_paged_kv", {"decode_kv_host_bytes": 1 << 24,
                                                                      "decode_prefix_slots": 1}))
    sched = server.decode_scheduler
    p8 = np.random.default_rng(11).integers(0, _model_runtime(server).params["tok_emb"].shape[0],
                                           size=(2, sched.seq_len))
    try:
        cold8, _ = await _tier_request(server, p8[0])
        await _tier_request(server, p8[1])  # its capture pushes A out: demoted
        warm8, _ = await _tier_request(server, p8[0])
        if sched.stat_tier_promotions != 1 or (warm8 != cold8).any():
            raise AssertionError(f"int8 pool: {sched.stat_tier_promotions} promotions; the warm row "
                                 f"{'equals' if (warm8 == cold8).all() else 'differs from'} the cold one")
        out["int8"] = {"promotions": sched.stat_tier_promotions, "warm_equals_cold": True}
    finally:
        await server.stop()
    print(f"[{card}] kv tiers: {json.dumps(out)}", flush=True)
    return out


async def feature_host_tier(card) -> dict:
    """Phase 9c: a copy of gpt2_small_feature_draft with the host tier and a
    one-entry prefix index through REST. A prompt A served cold, then warm
    from the device; B's capture pushes A out (demoted to host); A again,
    promoted from host: its greedy row bit for bit the device-warm row (and
    held to the cold one under the tie rule), and both warm admissions
    open the head's window past the reused span."""
    import numpy as np

    path = _deployment_copy("gpt2_small_feature_draft", {"decode_kv_host_bytes": 1 << 26, "decode_prefix_slots": 1})
    server, *_ = await _start(path)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, tier = sched.seq_len, sched._host_tier
    starts = []  # (reuse, the head's window start) per admission
    real = sched._install_admit

    def install(s, slot, entry, reuse, t0):
        real(s, slot, entry, reuse, t0)
        starts.append((reuse, int(sched._draft_start[slot])))

    sched._install_admit = install
    a, b = np.random.default_rng(12).integers(0, runtime.params["tok_emb"].shape[0], size=(2, seq))
    try:
        cold, cold_ms = await _tier_request(server, a)
        warm_dev, dev_ms = await _tier_request(server, a)
        await _tier_request(server, b)  # its capture pushes A out of the one-entry index
        if sched._prefix_index.match(a, touch=False)[1] or tier.probe(a, include_store=False) < seq:
            raise AssertionError("A was not demoted to host by B's capture")
        promotions = sched.stat_tier_promotions
        warm_host, host_ms = await _tier_request(server, a)
        if sched.stat_tier_promotions != promotions + 1:
            raise AssertionError("A was not promoted from host")
        recompiles = sched.recompiles_since_warmup()
    finally:
        del sched._install_admit
        await server.stop()
    if (warm_host != warm_dev).any():
        raise AssertionError("the feature deployment's A promoted from host served other ids than A warm from the device")
    reuse = seq - 1  # the last prompt position is always computed
    if starts != [(0, 0), (reuse, reuse), (0, 0), (reuse, reuse)] or recompiles != 0:
        raise AssertionError(f"feature host tier: admissions (reuse, window start) {starts}, recompiles {recompiles}")
    out = {"warm_host_equals_warm_device": True, "admissions": starts,
           "tie_rows": _hold_ids("feature A warm vs cold", [warm_dev], [cold], runtime.params, seq, "bfloat16"),
           "latency_ms": {"cold": cold_ms, "device": dev_ms, "host": host_ms}}
    print(f"[{card}] feature host tier: {json.dumps(out)}", flush=True)
    return out


async def serve_phase9(card) -> dict:
    """Phase 9, all parts in one event loop; it ends with the reconcile's
    rollbacks and deferrals (each provoked at least once)."""
    out = {"pipeline": await serve_pipeline(card), "tiers": await serve_kv_tiers(card),
           "feature_host_tier": await feature_host_tier(card)}
    p = out["pipeline"]
    print(f"[{card}] phase 9 stat_pipeline_rollbacks={p['faults']['rollback']['stat_pipeline_rollbacks']} "
          f"stat_pipeline_deferred={p['tight_pool']['deferred']}", flush=True)
    return out


# ---------------------------------------------------------------- phase 10
# Learning: online fine-tuning through REST feedback, and the distillation
# recipe at GPT-2-small width feeding a served feature head.

# (deployment, optimizer, lr, finetune_batch, taught class): the JAX
# test's sgd parameters on iris (float32), Adam on MNIST (bf16)
FINETUNE_CASES = (("iris", "sgd", 0.5, 8, 2), ("mnist", "adam", 1e-3, 8, 3))
FINETUNE_STEPS = 6  # steps per case, each one feedback of finetune_batch rows
FINETUNE_PROBE_ROWS = 4
FINETUNE_STEP_REPS = 10  # train steps timed after the checks
# the target of gpt2_small_feature_draft.json (seed 0) and its head, trained
# in float32 on 128-token prompts with 64 on-policy tokens
DISTILL = dict(seed=0, vocab=50257, hidden=768, layers=12, ffn=3072, max_len=192, resid_scale=0.1, seq=128,
               horizon=192, batch=16, lr=1e-3, teacher_temp=0.5, eval_prompts=16, features=True)
# about 26-30 s of training: 43.2-49.4 ms a step at this width (H100 80GB
# HBM3, 700 W; this phase, PERF.md); 1400 steps until the script grew
# past phase 14 (the accept proxy reached 0.87 there)
DISTILL_STEPS = 600
DISTILL_LOG_EVERY = 100


def _finetune_copy(name: str, opt: str, lr: float, batch: int) -> Path:
    """A copy of a deployment whose model unit fine-tunes from feedback."""
    dep = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    graph = dep["spec"]["predictors"][0]["graph"]
    graph["parameters"] += [
        {"name": "finetune", "value": "true", "type": "BOOL"},
        {"name": "finetune_batch", "value": str(batch), "type": "INT"},
        {"name": "finetune_lr", "value": str(lr), "type": "FLOAT"},
        {"name": "finetune_optimizer", "value": opt, "type": "STRING"},
    ]
    path = ROOT / "build" / f"{name}_finetune_{opt}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


def _snapshot(tree):
    """A host copy of a parameter tree (float32 numpy, never a view)."""
    import numpy as np

    from seldon_core_tpu_torch.models.convert import params_to_numpy, tree_map

    return tree_map(np.array, params_to_numpy(tree))


def record_versions(runtime) -> list:
    """Every tree ``runtime.load_params`` publishes, host copies, the
    weights it started with first."""
    versions = [_snapshot(runtime.params)]
    publish = runtime.load_params

    def record(tree):
        publish(tree)
        versions.append(_snapshot(tree))

    runtime.load_params = record
    return versions


def plant_torn_update(runtime) -> None:
    """The planted fault: an update that copies the first half of the
    leaves and leaves the rest on the old weights."""
    import torch

    from seldon_core_tpu_torch.models.convert import tree_map

    def torn(tree):
        dst, src = [], []
        tree_map(dst.append, runtime.params)
        tree_map(src.append, tree)
        with runtime.params_lock, torch.no_grad():
            for d, s in list(zip(dst, src))[: len(dst) // 2]:
                d.copy_(s)

    runtime.load_params = torn


def eager_rows(runtime, tree, x) -> "np.ndarray":
    """The served forward on ``tree``, eagerly: a twin runtime on the same
    device with the same buckets and dtype, no graph."""
    from seldon_core_tpu_torch.models.base import ModelRuntime

    twin = ModelRuntime(runtime.apply_fn, tree, device=runtime.device, buckets=runtime.buckets,
                        dtype=runtime.dtype, class_names=runtime.class_names, cuda_graphs=False)
    return twin.predict(x)


def check_versions(label: str, served: list, forwards: list) -> list:
    """Every served answer equals, bit for bit, the forward of one published
    version; returns how many answers each version served."""
    import numpy as np

    counts = [0] * len(forwards)
    for i, rows in enumerate(served):
        hits = [v for v, f in enumerate(forwards) if np.array_equal(rows, f)]
        if not hits:
            raise AssertionError(f"{label}: answer {i} of {len(served)} equals the forward of no published version "
                                 f"(a torn update?)")
        counts[hits[-1]] += 1
    return counts


async def _rest_probs(port: int, x) -> "np.ndarray":
    import numpy as np

    status, out, _ = await _post(port, json.dumps({"data": {"ndarray": x.tolist()}}).encode())
    if status != 200:
        raise AssertionError(f"predict returned HTTP {status}: {out}")
    return np.asarray(out["data"]["ndarray"], np.float32)


async def finetune_run(card, name: str, opt: str, lr: float, batch: int, taught: int, torn: bool = False) -> dict:
    """One fine-tuning deployment through REST: FINETUNE_STEPS labelled
    feedbacks of ``batch`` rows of class ``taught`` while a client predicts
    a probe without pause; every answer is the forward of one published
    version, the last answer the eager forward on the final weights, the
    taught class's probability rises and no dispatch key is added."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.online import OnlineFinetuneModelUnit

    server, _, _ = await _start(_finetune_copy(name, opt, lr, batch))
    label = f"{name} finetune {opt}{' (torn update planted)' if torn else ''}"
    try:
        unit = server.executor.root.unit
        rt = unit.runtime
        if not isinstance(unit, OnlineFinetuneModelUnit):
            raise AssertionError(f"{label}: the unit is a {type(unit).__name__}, not an OnlineFinetuneModelUnit")
        if torn:
            plant_torn_update(rt)
        versions = record_versions(rt)
        features = rt.feature_shape[0]
        rng = np.random.default_rng(11)
        scale = 8.0 if name == "iris" else 1.0
        probe = rng.uniform(0, scale, (FINETUNE_PROBE_ROWS, features)).round(3).astype(np.float32)
        before = await _rest_probs(server.port, probe)
        served, done = [before], asyncio.Event()

        async def predicting():
            while not done.is_set():
                served.append(await _rest_probs(server.port, probe))

        client = asyncio.ensure_future(predicting())
        feedback_ms = []
        try:
            for _ in range(FINETUNE_STEPS):
                x = np.concatenate([probe, rng.uniform(0, scale, (batch - len(probe), features))]).round(3)
                body = {"request": {"data": {"ndarray": x.tolist()}}, "response": {}, "reward": 1.0,
                        "truth": {"data": {"ndarray": [[taught]] * batch}}}
                status, _, payload, ms = await _request(server.port, json.dumps(body).encode(),
                                                        path="/api/v0.1/feedback")
                if status != 200:
                    raise AssertionError(f"{label}: feedback returned HTTP {status}: {payload[:300]!r}")
                feedback_ms.append(ms)
                await asyncio.sleep(0)
        finally:
            done.set()
            await client
        after = await _rest_probs(server.port, probe)
        served.append(after)
        if unit._steps_taken != FINETUNE_STEPS or len(versions) != FINETUNE_STEPS + 1:
            raise AssertionError(f"{label}: {unit._steps_taken} steps and {len(versions) - 1} published updates "
                                 f"for {FINETUNE_STEPS} full batches")
        forwards = [eager_rows(rt, v, probe) for v in versions]
        counts = check_versions(label, served, forwards)
        captured = rt.predict(probe)
        if not (np.array_equal(after, forwards[-1]) and np.array_equal(captured, forwards[-1])):
            raise AssertionError(f"{label}: the served answer after the last step is not the eager forward on the "
                                 f"final weights (max diff {float(np.abs(after - forwards[-1]).max())})")
        rise = float(after[:, taught].mean() - before[:, taught].mean())
        if rise <= 0:
            raise AssertionError(f"{label}: the taught class's mean probability moved by {rise}")
        if rt.recompiles_since_warmup() != 0:
            raise AssertionError(f"{label}: {rt.recompiles_since_warmup()} dispatch keys after warmup")
        # the step alone: FINETUNE_STEP_REPS more steps, each waited for
        bx = np.concatenate([probe, rng.uniform(0, scale, (batch - len(probe), features))]).astype(np.float32)
        by = np.full(batch, taught, np.int32)
        step_ms = []
        for _ in range(FINETUNE_STEP_REPS):
            t0 = time.perf_counter()
            unit._train(bx, by)
            if rt.device.type == "cuda":
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        await server.stop()
    row = dict(dtype=str(rt.dtype).removeprefix("torch."), optimizer=opt, lr=lr, batch=batch, steps=FINETUNE_STEPS,
               answers=len(served), answers_per_version=counts, taught_class=taught,
               taught_prob_before=float(before[:, taught].mean()), taught_prob_after=float(after[:, taught].mean()),
               train_step_ms=sorted(step_ms)[len(step_ms) // 2], feedback_request_ms=feedback_ms,
               keys_after_warmup=rt.recompiles_since_warmup())
    print(f"[{card}] finetune {name}: {json.dumps(row)}", flush=True)
    return row


async def serve_finetune(card) -> dict:
    """Phase 10a: each case, then the torn update planted on iris, which
    must fail the version check."""
    out = {name: await finetune_run(card, name, opt, lr, batch, taught)
           for name, opt, lr, batch, taught in FINETUNE_CASES}
    name, opt, lr, batch, taught = FINETUNE_CASES[0]
    try:
        await finetune_run(card, name, opt, lr, batch, taught, torn=True)
    except AssertionError as e:
        print(f"[{card}] finetune planted torn update failed its check (as it must): {e}", flush=True)
    else:
        raise AssertionError("planted fault passed its check: a torn parameter update")
    return out


@contextlib.contextmanager
def timed_steps(stamps: list):
    """Record the host time at every call of a feature-distillation step:
    consecutive stamps are one training iteration (the random rows' teacher
    forward, the step, and the readback of its metrics, which waits for
    the device)."""
    from seldon_core_tpu_torch.training import steps

    make = steps.make_feature_distill_step

    def timed(*args, **kw):
        step = make(*args, **kw)

        def run(state, batch):
            stamps.append(time.perf_counter())
            return step(state, batch)

        return run

    steps.make_feature_distill_step = timed
    try:
        yield
    finally:
        steps.make_feature_distill_step = make


def distill_feature_head(card, out: str) -> dict:
    """Phase 10b's training: ``distill(features=True)`` on the card at
    GPT-2-small width, the checkpoint written to ``out``."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.training.distill_draft import distill

    stamps: list = []
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_steps(stamps):
        report = distill(device=DEVICE, out=out, steps=DISTILL_STEPS, log_every=DISTILL_LOG_EVERY, **DISTILL)
    wall = time.perf_counter() - t0
    gaps = np.diff(stamps)
    # the pool's refreshes (every steps // 4) fall between two stamps
    step_s = float(np.median(gaps)) if len(gaps) else float("nan")
    row = dict(steps=DISTILL_STEPS, s_per_step=step_s, training_s=float(gaps.sum()) if len(gaps) else 0.0,
               wall_s=wall, **{k: report[k] for k in ("accept_proxy_before", "accept_proxy_after", "final_kl",
                                                        "final_top1", "final_feat_mse")},
               history=report["history"])
    print(f"[{card}] distill gpt2_small feature head: {json.dumps(row)}", flush=True)
    for k in ("final_kl", "final_feat_mse"):
        if not np.isfinite(report[k]):
            raise AssertionError(f"distillation ended with {k} = {report[k]}")
    if report["accept_proxy_after"] <= report["accept_proxy_before"]:
        raise AssertionError(f"distillation did not lift the accept proxy: {report['accept_proxy_before']} -> "
                             f"{report['accept_proxy_after']}")
    return row


async def serve_learning(card) -> dict:
    """Phase 10: fine-tuning through feedback (10a), then the distilled
    feature head served beside speculation off under phase 6's traffic
    (10b)."""
    import tempfile

    out = {"finetune": await serve_finetune(card)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "gpt2_small_head.npz")
        out["distill"] = distill_feature_head(card, ck)
        uri = f"zoo://draft?features=1&hidden={DISTILL['hidden']}&ffn={DISTILL['ffn']}&distilled={ck}"
        # every round a plain step_f below the floor: the eager twin's
        # second wave waits longer for a slot than the 2 s default queue
        # timeout on a slower host (as phase 6's tree copy does)
        path = _deployment_copy("gpt2_small_feature_draft", {"decode_draft_model": uri, "queue_timeout_ms": 30000.0})
        served = await serve_speculative(card, path)
    if served["accept_rate"] <= 0:
        raise AssertionError("the distilled feature head accepted no draft token")
    out["served"] = {k: served[k] for k in ("accept_rate", "mean_accepted_per_round", "tokens_per_target_dispatch",
                                            "plain_tokens_per_target_dispatch", "ms_per_token", "plain_ms_per_token",
                                            "rounds", "spec_rounds", "plain_rounds", "tie_rows")}
    print(f"[{card}] distilled head served: {json.dumps(out['served'])}", flush=True)
    return out


# ---------------------------------------------------------------- phase 11

# where the deployments' hf-bert:// and file:// URIs point, from the
# checkout's root (git-ignored; written here, or by the checkpoint CLI)
MODEL_STORE = Path("model_store")
HF_DIR = MODEL_STORE / "bert_base_hf"
FILE_DIR = MODEL_STORE / "bert_base"
HF_SEED = 11
HF_GEOMETRY: dict = {}  # init_bert's defaults: BERT-base
HF_LABELS = {"0": "negative", "1": "positive"}
FILE_MODEL = "bert_base"  # bert_base_flash's model, as a checkpoint
FILE_KWARGS = {"seed": 0, "seq": 512, "attn_kernel": "pallas"}
LATENCY_ROUNDS = 25  # rounds of (flash, hf, hf, flash) requests at 1 user
SHADOW_ROWS = 24  # requests per turn of the shadow comparison
MNIST_CNN_ATOL = 1e-5
OUTLIER_ROWS = ([99000000.0, 10.0, 10.0], [178197.0, 833883.0, 855113.0], [1000.0, 2e6, 3e6])


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file of float32 tensors, as ``save_pretrained``
    writes one: the 8-byte little-endian header length, the JSON header
    (dtype, shape, ``data_offsets`` counted from the byte after the header,
    padded with spaces to 8 bytes), then each tensor's bytes in order."""
    import numpy as np

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, dtype=np.float32).tobytes())


def hf_bert_checkpoint(path: Path, seed: int, **geometry) -> dict:
    """A ``save_pretrained``-shaped directory of a BERT-base
    ``BertForSequenceClassification`` with seeded weights: ``config.json``
    and ``model.safetensors`` under Hugging Face's key names. The encoder,
    embeddings and head are ``init_bert(seed)`` (zoo://bert_base's draws),
    mapped back to torch's [out, in] Linear layout; the token-type table
    and the tanh pooler are drawn after them from the same seed. Returns
    the tree ``bert_params_from_hf`` must recover from the files."""
    import numpy as np

    from seldon_core_tpu_torch.models.bert import _dense_init, init_bert

    params = init_bert(seed, **geometry)
    hidden = params["tok_emb"].shape[1]
    rng = np.random.default_rng([seed, 1])
    type_emb = (rng.standard_normal((2, hidden)) * 0.02).astype(np.float32)
    pooler = _dense_init(rng, hidden, hidden)
    pooler["b"] = (rng.standard_normal(hidden) * 0.02).astype(np.float32)
    state = {
        "bert.embeddings.word_embeddings.weight": params["tok_emb"],
        "bert.embeddings.position_embeddings.weight": params["pos_emb"],
        "bert.embeddings.token_type_embeddings.weight": type_emb,
        "bert.embeddings.LayerNorm.weight": params["ln_emb"]["scale"],
        "bert.embeddings.LayerNorm.bias": params["ln_emb"]["bias"],
    }
    for i, lp in enumerate(params["layers"]):
        pre = f"bert.encoder.layer.{i}"
        for j, m in enumerate(("query", "key", "value")):
            state[f"{pre}.attention.self.{m}.weight"] = lp["qkv"]["w"][:, j * hidden:(j + 1) * hidden].T
            state[f"{pre}.attention.self.{m}.bias"] = lp["qkv"]["b"][j * hidden:(j + 1) * hidden]
        for key, leaf in (("attention.output.dense", "attn_out"), ("intermediate.dense", "mlp_in"),
                          ("output.dense", "mlp_out")):
            state[f"{pre}.{key}.weight"] = lp[leaf]["w"].T
            state[f"{pre}.{key}.bias"] = lp[leaf]["b"]
        for key, leaf in (("attention.output.LayerNorm", "ln1"), ("output.LayerNorm", "ln2")):
            state[f"{pre}.{key}.weight"] = lp[leaf]["scale"]
            state[f"{pre}.{key}.bias"] = lp[leaf]["bias"]
    state["bert.pooler.dense.weight"] = pooler["w"].T
    state["bert.pooler.dense.bias"] = pooler["b"]
    state["classifier.weight"] = params["head"]["w"].T
    state["classifier.bias"] = params["head"]["b"]
    layers = len(params["layers"])
    config = {
        "architectures": ["BertForSequenceClassification"], "model_type": "bert", "vocab_size": params["tok_emb"].shape[0],
        "hidden_size": hidden, "num_hidden_layers": layers, "num_attention_heads": hidden // 64,
        "intermediate_size": params["layers"][0]["mlp_in"]["w"].shape[1],
        "max_position_embeddings": params["pos_emb"].shape[0], "type_vocab_size": 2, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
        "id2label": HF_LABELS, "label2id": {v: int(k) for k, v in HF_LABELS.items()},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config, indent=2))
    write_safetensors(path / "model.safetensors", state)
    return {**params, "pos_emb": params["pos_emb"] + type_emb[0][None, :], "pooler": pooler}


def write_model_store(card) -> dict:
    """Phase 11a: the HF directory and the file:// checkpoint, then each read
    back on the host and held to what was written."""
    import numpy as np

    from seldon_core_tpu_torch.models.hf_import import bert_params_from_hf, load_hf_bert_dir
    from seldon_core_tpu_torch.models.zoo import get_model
    from seldon_core_tpu_torch.persistence.checkpoint import restore_model, save_model

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return isinstance(b, dict) and sorted(a) == sorted(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return isinstance(b, list) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a.dtype == b.dtype and np.array_equal(a, b)

    t0 = time.perf_counter()
    want = hf_bert_checkpoint(HF_DIR, HF_SEED, **HF_GEOMETRY)
    t1 = time.perf_counter()
    state, config = load_hf_bert_dir(str(HF_DIR))
    got = bert_params_from_hf(state)
    t2 = time.perf_counter()
    if not same(got, want):
        raise AssertionError("the HF directory read back is not the tree it was written from")
    ms = get_model(FILE_MODEL, **FILE_KWARGS)
    t3 = time.perf_counter()
    save_model(str(FILE_DIR), FILE_MODEL, ms.params, FILE_KWARGS)
    t4 = time.perf_counter()
    restored = restore_model(str(FILE_DIR))
    t5 = time.perf_counter()
    if not same(restored.params, ms.params):
        raise AssertionError("the file:// checkpoint restores other arrays than zoo://bert_base's")
    sizes = {p.name: p.stat().st_size for d in (HF_DIR, FILE_DIR) for p in sorted(d.iterdir())}
    row = dict(hf_write_s=t1 - t0, hf_read_s=t2 - t1, zoo_build_s=t3 - t2, file_write_s=t4 - t3,
               file_restore_s=t5 - t4, bytes=sizes, labels=config["id2label"])
    print(f"[{card}] phase 11 model store {json.dumps(row)}", flush=True)
    return row


async def _serve_batches(server, batches, counter, classes: int = 2) -> tuple[list, list, list, int]:
    """POST each batch of ids with ``counter`` reset first: (probabilities,
    launches per request, latency ms per request, launches in all)."""
    probs, deltas, latencies = [], [], []
    counter.reset()  # the path's run starts here
    for ids in batches:
        before = counter.count
        status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
        if status != 200:
            raise AssertionError(f"predict returned HTTP {status}: {out}")
        probs.append(_check_probs(out, len(ids), classes))
        deltas.append(counter.count - before)
        latencies.append(ms)
    return probs, deltas, latencies, counter.count  # ... and ends here


async def p50_in_turns(servers: dict, body: bytes, rounds: int) -> dict:
    """Median request ms of each server at one user, requests sent in turns
    (a, b, b, a, ...)."""
    names = list(servers)
    lat = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            status, out, ms = await _post(servers[n].port, body)
            if status != 200:
                raise AssertionError(f"{n} predict returned HTTP {status}: {out}")
            lat[n].append(ms)
    return {n: sorted(v)[len(v) // 2] for n, v in lat.items()}


def busy_ms(runtime, ids) -> float | None:
    """Device busy ms of one served forward (torch.profiler), None when the
    profiler sees no device activity."""
    kernels, _ = profile_device(lambda: runtime.predict(ids))
    busy = sum(kernels.values())
    return busy if busy > 0 else None


async def serve_model_sources(card) -> dict:
    """Phase 11b: ``bert_base_hf`` (the HF directory at seq 512, the flash
    kernel) and ``bert_base_file`` (the checkpoint) through REST, beside
    phase 3's ``bert_base_flash``; then ``bert_base_hf_int8`` (phase 7c's
    checks, 50 W8A16 launches a forward). Returns the launches of each."""
    import numpy as np

    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    rng = np.random.default_rng(21)
    servers, out = {}, {}
    try:
        for name in ("bert_base_hf", "bert_base_file", "bert_base_flash"):
            servers[name], build_s, warm_s = await _start(BASELINE_DIR / f"{name}.json")
            rt = _model_runtime(servers[name])
            print(f"[{card}] serve: {name}.json layers={len(rt.params['layers'])} seq={rt.feature_shape[0]} "
                  f"dtype={rt.dtype} buckets={rt.buckets} pooler={'pooler' in rt.params} "
                  f"classes={list(rt.class_names)} build_s={build_s:.3f} warmup_s={warm_s:.3f}", flush=True)
        runtimes = {n: _model_runtime(s) for n, s in servers.items()}
        layers, seq = len(runtimes["bert_base_hf"].params["layers"]), runtimes["bert_base_hf"].feature_shape[0]
        vocab = runtimes["bert_base_hf"].params["tok_emb"].shape[0]
        batches = [rng.integers(0, vocab, size=(n, seq)) for n in (1, 8, 1, 8)]
        served = {}
        for name in ("bert_base_hf", "bert_base_file", "bert_base_flash"):
            probs, deltas, latencies, launches = await _serve_batches(servers[name], batches, LAUNCHES)
            served[name] = probs
            out[name] = launches
            print(f"[{card}] {name} requests batch={[len(b) for b in batches]} latency_ms="
                  f"{[round(ms, 3) for ms in latencies]} flash_attention launches per request={deltas}", flush=True)
            require_launches(f"{name} flash_attention", deltas, layers)
        same = all(np.array_equal(a, b) for a, b in zip(served["bert_base_file"], served["bert_base_flash"]))
        print(f"[{card}] bert_base_file vs zoo://bert_base (bert_base_flash) on the same requests: "
              f"bit_identical={same}", flush=True)
        if not same:
            raise AssertionError("bert_base_file's answers differ from zoo://bert_base's at the same seed")
        # at these random weights the tanh pooler reads a [CLS] state that
        # barely moves with the attention (on an H100 at 700 W, uniform attention
        # moved the answers 0.003), so the wrong attentions are printed, not
        # required; phase 3 shows the check's power on zoo://bert_base
        check_served_bert(card, "bert_base_hf",
                          [(runtimes["bert_base_hf"], ids, p) for ids, p in zip(batches, served["bert_base_hf"])],
                          require_controls=False)
        keys = {n: rt.recompiles_since_warmup() for n, rt in runtimes.items()}
        print(f"[{card}] phase 11 keys after warmup: {json.dumps(keys)}", flush=True)
        if any(keys.values()):
            raise AssertionError(f"new keys after warmup: {keys}")
        body = json.dumps({"data": {"ndarray": batches[0].tolist()}}).encode()
        p50 = await p50_in_turns({n: servers[n] for n in ("bert_base_flash", "bert_base_hf")}, body, LATENCY_ROUNDS)
        busy = {}
        for ids in batches[:2]:  # in turns: flash, hf, flash
            for n in ("bert_base_flash", "bert_base_hf", "bert_base_flash"):
                busy.setdefault(f"{n}_b{len(ids)}", []).append(busy_ms(runtimes[n], ids))
        print(f"[{card}] phase 11 request p50_ms at 1 user, batch 1 (in turns): {json.dumps(p50)}; device busy ms "
              f"per forward: {json.dumps(busy)}", flush=True)
        out.update(p50_ms=p50, device_busy_ms=busy, keys_after_warmup=keys)
    finally:
        for s in servers.values():
            await s.stop()
    del servers, runtimes
    want = INT8_LAUNCHES + 1  # bert_int8's 49 and the pooler's
    by_body = {**INT8_LAUNCHES_BY_BODY, "wgmma": INT8_LAUNCHES_BY_BODY["wgmma"] + 1}  # the pooler: N = 768
    out["bert_base_hf_int8"], out["bert_base_hf_int8_by_body"] = await serve_bert_int8(
        card, "bert_base_hf_int8", want, by_body)
    return out


def _metric_delta(before: str, after: str, name: str, **labels) -> float:
    return metric_total(metric_samples(after), name, **labels) - metric_total(metric_samples(before), name, **labels)


async def serve_fraud_outlier(card) -> dict:
    """Phase 11c: fraud_outlier (the built-in z-score detector ahead of
    mean_classifier): tags as the stored statistics give them, answers as
    the classifier's CPU forward."""
    import numpy as np

    server, build_s, warm_s = await _start(BASELINE_DIR / "fraud_outlier.json")
    try:
        replies = []
        for row in OUTLIER_ROWS:
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": [row]}}).encode())
            if status != 200:
                raise AssertionError(f"fraud_outlier predict returned HTTP {status}: {out}")
            replies.append((out, ms))
    finally:
        await server.stop()
    od = server.executor.root.unit
    runtime = server.executor.root.children[0].unit.runtime
    cache, worst, tags = {}, 0.0, []
    for row, (out, _) in zip(OUTLIER_ROWS, replies):
        x = np.asarray([row], np.float32)
        score = float(np.max(np.abs((x - od.means) / od.stds)))
        want = {"outlierScore": score, "outlier": score > od.threshold}
        tags.append(out["meta"]["tags"])
        if out["meta"]["tags"] != want:
            raise AssertionError(f"fraud_outlier tags {out['meta']['tags']}, the stored statistics give {want}")
        worst = max(worst, float(np.abs(np.asarray(out["data"]["ndarray"]) - cpu_forward(runtime, x, cache)).max()))
    print(f"[{card}] fraud_outlier tags={json.dumps(tags)} request_ms={[round(ms, 3) for _, ms in replies]} "
          f"vs the CPU forward: max_abs_diff={worst} (atol {SMALL_ATOL['float32']})", flush=True)
    if worst > SMALL_ATOL["float32"] or [t["outlier"] for t in tags] != [True, False, False]:
        raise AssertionError(f"fraud_outlier: answers off by {worst}, tags {tags}")
    return {"tags": tags}


async def serve_shadow(card) -> dict:
    """Phase 11d: iris_shadow beside its primary alone, in turns (shadow,
    plain, plain, shadow): every primary answer equal, bit for bit, to the
    plain deployment's; the candidate's agreement counted once per request
    on /metrics; the primary's p50 both ways. Then a failing candidate is
    planted (the chaos harness, every call fails): the answers stay the
    same and every mirror counts a disagreement."""
    import numpy as np

    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults

    family = "seldon_tpu_shadow_comparisons_total"
    rows = np.random.default_rng(31).uniform(0, 8, size=(SHADOW_ROWS, 4)).round(2)
    bodies = [json.dumps({"data": {"ndarray": [r.tolist()]}}).encode() for r in rows]
    shadow, *_ = await _start(BASELINE_DIR / "iris_shadow.json")
    plain, *_ = await _start(_primary_only("iris_shadow"))
    try:
        before = (await _get(shadow.port, "/metrics")).decode()
        answers = {"shadow": [], "plain": []}
        lat = {"shadow": [], "plain": []}
        for i, body in enumerate(bodies):
            for name in (("shadow", "plain", "plain", "shadow") if i % 2 == 0 else ("plain", "shadow", "shadow", "plain")):
                status, out, ms = await _post((shadow if name == "shadow" else plain).port, body)
                if status != 200:
                    raise AssertionError(f"iris_shadow ({name}) predict returned HTTP {status}: {out}")
                answers[name].append(out["data"]["ndarray"])
                lat[name].append(ms)
        await shadow.executor.drain_shadows()
        mid = (await _get(shadow.port, "/metrics")).decode()
        install_faults(shadow.executor, {"candidate": FaultSpec(error_rate=1.0, seed=5)})
        planted = []
        for body in bodies:
            status, out, _ = await _post(shadow.port, body)
            if status != 200:
                raise AssertionError(f"iris_shadow with a failing candidate returned HTTP {status}: {out}")
            planted.append(out["data"]["ndarray"])
        await shadow.executor.drain_shadows()
        after = (await _get(shadow.port, "/metrics")).decode()
    finally:
        await shadow.stop()
        await plain.stop()
    agree = {v: _metric_delta(before, mid, family, shadow_unit="candidate", agree=v) for v in ("true", "false")}
    failed = {v: _metric_delta(mid, after, family, shadow_unit="candidate", agree=v) for v in ("true", "false")}
    p50 = {n: sorted(v)[len(v) // 2] for n, v in lat.items()}
    same = answers["shadow"] == answers["plain"]
    unchanged = planted == answers["shadow"][::2]
    print(f"[{card}] iris_shadow {2 * SHADOW_ROWS} requests: primary answers equal to the plain deployment's: {same}; "
          f"agreement counts {json.dumps(agree)}; primary p50_ms with the candidate mirrored {p50['shadow']:.3f}, "
          f"candidate removed {p50['plain']:.3f}", flush=True)
    print(f"[{card}] iris_shadow with a failing candidate planted: answers unchanged {unchanged}; agreement counts "
          f"{json.dumps(failed)}", flush=True)
    if not same or not unchanged:
        raise AssertionError("a shadow changed the primary's answers")
    if sum(agree.values()) != 2 * SHADOW_ROWS or failed != {"true": 0.0, "false": float(SHADOW_ROWS)}:
        raise AssertionError(f"shadow comparisons miscounted: {agree} then {failed}")
    return {"agreement": agree, "failing_candidate": failed, "p50_ms": p50}


def _with_device(name: str) -> Path:
    """The deployment as it is on the card; elsewhere a copy whose user
    class is built on DEVICE."""
    path = BASELINE_DIR / f"{name}.json"
    if DEVICE == "cuda":
        return path
    dep = json.loads(path.read_text())
    dep["spec"]["predictors"][0]["graph"]["parameters"].append({"name": "device", "value": DEVICE, "type": "STRING"})
    path = ROOT / "build" / f"{name}_{DEVICE}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


async def serve_mnist_cnn(card) -> dict:
    """Phase 11e: mnist_cnn (PYTHON_CLASS MnistCnn, trained on the card at
    build, 80 Adam steps): accuracy on its synthetic set through REST, its
    forward held to the same parameters' forward on the CPU, and how long
    a request's predict (forward and readback, inline on the event loop's
    thread) holds the loop."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    server, build_s, warm_s = await _start(_with_device("mnist_cnn"))
    user = server.executor.root.unit.user
    try:
        x, y = user.train_x, user.train_y
        probs = []
        for i in range(0, len(x), 128):
            status, out, _ = await _post(server.port, json.dumps({"data": {"ndarray": x[i:i + 128].tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"mnist_cnn predict returned HTTP {status}: {out}")
            probs.append(np.asarray(out["data"]["ndarray"]))
    finally:
        await server.stop()
    accuracy = 100.0 * float((np.concatenate(probs).argmax(axis=1) == y).mean())
    cpu = object.__new__(type(user))
    cpu.device = torch.device("cpu")
    cpu._params = {k: {n: t.cpu() for n, t in v.items()} for k, v in user._params.items()}
    diff = float(np.abs(user.predict(x[:128], []) - cpu.predict(x[:128], [])).max())
    stall = {n: wall_ms(lambda n=n: user.predict(x[:n], []), reps=20) for n in (1, 128)}
    row = dict(build_and_train_s=build_s, accuracy_pct=accuracy, vs_cpu_forward=diff, loop_stall_ms=stall)
    print(f"[{card}] mnist_cnn {json.dumps(row)} (forward atol {MNIST_CNN_ATOL})", flush=True)
    if diff > MNIST_CNN_ATOL or accuracy < 90.0:
        raise AssertionError(f"mnist_cnn: accuracy {accuracy}%, forward vs the CPU {diff}")
    return row


async def serve_gbm(card) -> str:
    """gbm.json fits an sklearn model at construction; on a host without
    sklearn it is skipped, on a line that says so."""
    import importlib.util

    if importlib.util.find_spec("sklearn") is None:
        print(f"[{card}] gbm.json skipped: GbmClassifier fits an sklearn HistGradientBoostingClassifier at "
              "construction and this host has no sklearn", flush=True)
        return "skipped: no sklearn on this host"
    server, *_ = await _start(BASELINE_DIR / "gbm.json")
    try:
        status, out, _ = await _post(server.port, json.dumps({"data": {"ndarray": [[10.0] * 30]}}).encode())
    finally:
        await server.stop()
    if status != 200:
        raise AssertionError(f"gbm predict returned HTTP {status}: {out}")
    _check_probs(out, 1)
    print(f"[{card}] gbm.json served: {out['data']['ndarray']}", flush=True)
    return "served"


async def serve_user_code(card) -> dict:
    """Phase 11c-f: the outlier detector, the shadow, a user class on the
    card, and gbm where sklearn is at hand."""
    return {"fraud_outlier": await serve_fraud_outlier(card), "iris_shadow": await serve_shadow(card),
            "mnist_cnn": await serve_mnist_cnn(card), "gbm": await serve_gbm(card)}


# ---------------------------------------------------------------- phase 12
FLEET_GROUPS = 8  # system prompts
FLEET_PER_GROUP = 4  # requests per system prompt: its opener, then 3 sharers
FLEET_SHARED = 96  # tokens of a system prompt; 32 distinct tokens follow
FLEET_STAGGER_S = 0.004
FLEET_MIN_NEW = 8  # budgets of 8 to 32 new tokens
FLEET_STORE = Path("fleet_spill_store")  # the spill store (git-ignored), relative to the checkout
FLEET_HANG_S = 0.4  # the hung round's sleep: eviction, migration, then readmission
# the hung replica's eviction: at most threshold polls after the first
# missed probe, and (threshold + 1) polls plus this slack after the hang
# begins (the poll right after it may still see the ticks of the rounds
# before it; each poll waits for the loop)
FLEET_EVICT_SLACK_MS = 20.0
FLEET_SCALE_EVERY_S = 0.01  # the scale-up traffic tops the queue up to twice the autoscale depth this often
FLEET_SCALE_LIMIT_S = 60.0


def fleet_groups(seq: int, vocab: int, seed: int):
    """FLEET_GROUPS system prompts of FLEET_SHARED tokens, each followed by
    distinct tokens in FLEET_PER_GROUP requests: (openers, sharers,
    opener budgets, sharer budgets). Sharers come group by group."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heads = rng.integers(0, vocab, size=(FLEET_GROUPS, FLEET_SHARED))
    prompts = [[np.concatenate([h, rng.integers(0, vocab, seq - FLEET_SHARED)]) for _ in range(FLEET_PER_GROUP)]
               for h in heads]
    openers = np.stack([g[0] for g in prompts])
    sharers = np.stack([p for g in prompts for p in g[1:]])
    budgets = [int(b) for b in rng.integers(FLEET_MIN_NEW, 33, size=FLEET_GROUPS * FLEET_PER_GROUP)]
    return openers, sharers, budgets[:FLEET_GROUPS], budgets[FLEET_GROUPS:]


async def _sse_timed(port: int, ids, budget: int) -> dict:
    """One SSE request: its events, the ms to the first token event and to
    the end, and the ids of its done event."""
    body = json.dumps({"meta": {"tags": {"max_new_tokens": budget}}, "data": {"ndarray": [ids.tolist()]}}).encode()
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"POST /api/v0.1/predictions/stream HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json"
                 b"\r\nContent-Length: %d\r\nConnection: close\r\n\r\n" % len(body) + body)
    await writer.drain()
    raw, ttft = b"", None
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            break
        raw += chunk
        if ttft is None and b'"token"' in raw:
            ttft = (time.perf_counter() - t0) * 1e3
    writer.close()
    wall = (time.perf_counter() - t0) * 1e3
    head, _, rest = raw.partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/1.1 200"):
        raise AssertionError(f"stream returned {head[:80]!r}: {rest[:300]!r}")
    data = b""
    while rest:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            break
        data, rest = data + rest[:size], rest[size + 2:]
    events = [json.loads(f[6:]) for f in data.split(b"\n\n") if f.startswith(b"data: ")]
    done = events[-1]
    if not done.get("done"):
        raise AssertionError(f"stream ended without its done event: {events[-1]}")
    return {"events": events[:-1], "ids": done["ids"][0], "ttft_ms": ttft, "wall_ms": wall}


def stream_check(label: str, reply: dict, seq: int) -> None:
    """The client's stream is the reply's generated ids, each once, in
    order, at its own index: nothing streamed twice, nothing skipped."""
    got = [(e["token"], e["index"]) for e in reply["events"]]
    want = [(t, i) for i, t in enumerate(reply["ids"][seq:])]
    if got != want:
        raise AssertionError(f"{label}: streamed {got[:40]}, the reply generated {want[:40]}")


async def fleet_traffic(port: int, openers, sharers, ob, sb) -> tuple[list, float]:
    """The openers staggered by FLEET_STAGGER_S (each system prompt's first
    request), awaited, then the sharers group by group the same way: every
    request an SSE stream. (replies in group order, wall seconds)."""
    async def wave(prompts, budgets):
        async def one(i):
            await asyncio.sleep(FLEET_STAGGER_S * i)
            return await _sse_timed(port, prompts[i], budgets[i])

        return await asyncio.gather(*(one(i) for i in range(len(prompts))))

    t0 = time.perf_counter()
    first = await wave(openers, ob)
    rest = await wave(sharers, sb)
    return first + rest, time.perf_counter() - t0


def fleet_rows(label: str, replies, budgets, seq: int) -> list:
    import numpy as np

    rows = []
    for r, b in zip(replies, budgets):
        stream_check(label, r, seq)
        if len(r["ids"]) - seq != b:
            raise AssertionError(f"{label}: a reply generated {len(r['ids']) - seq} tokens, budget {b}")
        rows.append(np.asarray(r["ids"], np.int64))
    return rows


def _percentile(xs: list, q: float) -> float:
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))], 3)


def _fleet_counts(sched) -> dict:
    """Prefix hits, misses, sibling pulls and shed routes of a scheduler or
    a fleet, cumulative."""
    bal = getattr(sched, "balancer", None)
    return dict(hits=sched.stat_prefix_hits, misses=sched.stat_prefix_misses,
                pulls=getattr(sched, "stat_sibling_pulls", 0), sheds=bal.stat_routes["shed"] if bal else 0)


def cold_check(label: str, counts: dict) -> None:
    """One cold prefix capture per system prompt: exactly one cold prefill
    a group, and no replica pulling a group's pages from a sibling except
    where the bounded-load shed moved a request off its home."""
    if counts["misses"] != FLEET_GROUPS or counts["pulls"] > counts["sheds"]:
        raise AssertionError(f"{label}: {counts['misses']} cold prefills and {counts['pulls']} sibling pulls for "
                             f"{FLEET_GROUPS} system prompts ({counts['sheds']} shed routes)")


async def _start_fleet(path: Path):
    """``_start`` for a fleet deployment, recording each replica's growth of
    memory_reserved() over its own warmup."""
    import torch

    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, name = load_predictor(str(path))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=name, device=DEVICE)
    t1 = time.perf_counter()
    on_card = DEVICE == "cuda"
    if on_card:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    server.replica_warmup_bytes = {}
    for i, r in server.decode_scheduler.live_replicas:
        def warm(r=r, i=i, real=r.warmup):
            before = torch.cuda.memory_reserved() if on_card else 0
            real()
            if on_card:
                torch.cuda.synchronize()
            server.replica_warmup_bytes[i] = (torch.cuda.memory_reserved() - before) if on_card else 0

        r.warmup = warm
    server.warmup()
    t2 = time.perf_counter()
    await server.start("127.0.0.1", 0)
    return server, t1 - t0, t2 - t1


def _one_replica_copy(slots: int, pages: int, entries: int) -> Path:
    """A one-replica copy of gpt2_small_replicated under its own name (each
    server's flight recorder is registered by its deployment's name)."""
    path = _deployment_copy("gpt2_small_replicated", {
        "decode_replicas": 1, "decode_router_policy": "", "decode_autoscale_replicas": 0,
        "decode_autoscale_queue_depth": 0, "decode_health_poll_ms": 0, "decode_slots": slots,
        "decode_kv_pages": pages, "decode_prefix_slots": entries})
    dep = json.loads(path.read_text())
    dep["spec"]["name"] = dep["metadata"]["name"] = f"{dep['spec']['name']}-one{slots}"
    path = path.with_name(f"gpt2_small_replicated_one{slots}.json")
    path.write_text(json.dumps(dep))
    return path


def _pool_bytes(sched) -> int:
    return sum(int(a.numel()) * a.element_size() for a in sched.pool.state)


async def fleet_runs(card, fleet, one8, one16, params) -> dict:
    """Phase 12a: the affinity fleet and the two one-replica copies under
    the same traffic in turns (fleet, one8, one16, then fresh system prompts
    one16, one8, fleet): every greedy row bit for bit one8's, held to one16's
    and the fused generate's under the tie rule; one cold capture per system
    prompt each; zero keys after warmup; /metrics routes rising by exactly
    the requests; tokens/s, TTFT p50/p99, and per replica the round's wall,
    busy and host share. Then the same fleet under round robin (more cold
    captures, sibling pulls) and a router planted to ignore the prefix key
    (must fail the cold-capture count)."""
    import numpy as np

    sched = fleet.decode_scheduler
    seq, vocab = sched.seq_len, int(params["tok_emb"].shape[0])
    servers = {"fleet": fleet, "one8": one8, "one16": one16}
    numbers, rows_by_seed = {n: [] for n in servers}, {}
    for seed, order in ((121, ("fleet", "one8", "one16")), (122, ("one16", "one8", "fleet"))):
        openers, sharers, ob, sb = fleet_groups(seq, vocab, seed)
        budgets = ob + sb
        rows = {}
        for name in order:
            srv = servers[name]
            s = srv.decode_scheduler
            c0 = _fleet_counts(s)
            m0 = metric_samples((await _get(srv.port, "/metrics")).decode())
            since = {i: r.flight.rounds for i, r in (s.live_replicas if name == "fleet" else [(0, s)])}
            replies, wall = await fleet_traffic(srv.port, openers, sharers, ob, sb)
            c1 = _fleet_counts(s)
            m1 = metric_samples((await _get(srv.port, "/metrics")).decode())
            counts = {k: c1[k] - c0[k] for k in c0}
            rows[name] = fleet_rows(f"fleet 12a {name}", replies, budgets, seq)
            cold_check(f"fleet 12a {name} seed {seed}", counts)
            ttft = [r["ttft_ms"] for r in replies]
            run = dict(seed=seed, tokens_per_s=round(sum(budgets) / wall, 2), ttft_p50_ms=_percentile(ttft, 0.5),
                       ttft_p99_ms=_percentile(ttft, 0.99), **counts)
            if name == "fleet":
                routed = metric_total(m1, "seldon_tpu_router_routes_total") - metric_total(
                    m0, "seldon_tpu_router_routes_total")
                if routed != len(budgets):
                    raise AssertionError(f"fleet 12a: /metrics counted {routed} routes for {len(budgets)} requests")
                run["routes"] = routed
            run["replicas"] = {}
            for i, r in (s.live_replicas if name == "fleet" else [(0, s)]):
                n = phase_split(await _frames_of(srv.port, r.flight.name, since[i]))
                run["replicas"][i] = dict(rounds=n["rounds"], wall_ms=n["wall_ms"], busy_ms=n["busy_ms"],
                                          host_share=round(n["gap_ms"] / n["wall_ms"], 4) if n["wall_ms"] else 0)
            numbers[name].append(run)
            if s.recompiles_since_warmup() != 0:
                raise AssertionError(f"fleet 12a {name}: {s.recompiles_since_warmup()} dispatch keys after warmup")
        diff = [r for r, (a, b) in enumerate(zip(rows["fleet"], rows["one8"])) if (a != b).any()]
        if diff:
            raise AssertionError(f"fleet 12a seed {seed}: fleet rows {diff} differ from the one-replica copy's")
        runtime = _model_runtime(fleet)
        ref = _fused_oracle(runtime, np.concatenate([openers, sharers]))
        ties = {"one16": _hold_ids("fleet 12a one16", rows["fleet"], rows["one16"], params, seq, "bfloat16"),
                "fused": _hold_ids("fleet 12a fused", rows["fleet"], ref, params, seq, "bfloat16")}
        one16_equal = all((a == b).all() for a, b in zip(rows["fleet"], rows["one16"]))
        print(f"[{card}] fleet 12a seed {seed}: rows bit for bit one8's; one16 equal {one16_equal}, ties "
              f"{json.dumps(ties)}", flush=True)
        rows_by_seed[seed] = (openers, sharers, budgets, rows["fleet"])
    print(f"[{card}] fleet 12a in turns: {json.dumps(numbers)}", flush=True)

    # round robin on the same fleet, fresh system prompts, against one8
    openers, sharers, ob, sb = fleet_groups(seq, vocab, 123)
    budgets = ob + sb
    sched.policy = sched.balancer.policy = "round_robin"
    c0 = _fleet_counts(sched)
    replies, wall = await fleet_traffic(fleet.port, openers, sharers, ob, sb)
    rr = {k: v - c0[k] for k, v in _fleet_counts(sched).items()}
    sched.policy = sched.balancer.policy = "affinity"
    rr_rows = fleet_rows("fleet 12a round_robin", replies, budgets, seq)
    one_replies, _ = await fleet_traffic(one8.port, openers, sharers, ob, sb)
    one_rows = fleet_rows("fleet 12a round_robin one8", one_replies, budgets, seq)
    if any((a != b).any() for a, b in zip(rr_rows, one_rows)):
        raise AssertionError("fleet 12a: round-robin rows differ from the one-replica copy's")
    rr["cold_captures"] = rr["misses"] + rr["pulls"]
    rr["tokens_per_s"] = round(sum(budgets) / wall, 2)
    if rr["cold_captures"] <= FLEET_GROUPS or rr["pulls"] < 1:
        raise AssertionError(f"fleet 12a round robin paid no more cold captures than affinity: {rr}")
    must_fail("fleet 12a round robin held to affinity's count", lambda: cold_check("round robin", rr))

    # planted: a router that ignores the prefix key
    openers, sharers, ob, sb = fleet_groups(seq, vocab, 124)
    real = sched.balancer.pick
    sched.balancer.pick = lambda key, depths=None: real((), depths)
    c0 = _fleet_counts(sched)
    try:
        replies, _ = await fleet_traffic(fleet.port, openers, sharers, ob, sb)
    finally:
        del sched.balancer.pick
    planted = {k: v - c0[k] for k, v in _fleet_counts(sched).items()}
    fleet_rows("fleet 12a keyless router", replies, ob + sb, seq)
    must_fail("a router that ignores the prefix key", lambda: cold_check("keyless router", planted))
    print(f"[{card}] fleet 12a round robin {json.dumps(rr)}; planted keyless router {json.dumps(planted)} "
          f"(failed the cold-capture check)", flush=True)
    if sched.recompiles_since_warmup() != 0:
        raise AssertionError(f"fleet 12a: {sched.recompiles_since_warmup()} keys after warmup")
    return {"turns": numbers, "round_robin": rr, "planted_keyless": planted, "rows": rows_by_seed[121]}


def _record_read_outs(fleet_body: bytes, health_body: bytes, name: str, seen: dict) -> None:
    """Each replica's state as a /decode/fleet and a /decode/health body
    show it, appended to ``seen``."""
    for r in json.loads(fleet_body)["replicas"]:
        seen.setdefault(("fleet", r["replica"]), []).append(r["state"])
    for rec, h in json.loads(health_body).items():
        if rec.startswith(f"{name}/r"):
            seen.setdefault(("health", h["replica_id"]), []).append(h["state"])


def _read_outs_now(server, seen: dict) -> None:
    """What the two routes' handlers answer at this instant (called from the
    state funnel: an eviction may last one poll interval, shorter than an
    HTTP round trip under traffic)."""
    from seldon_core_tpu_torch.serving import wire

    get = lambda path: wire.WireRequest("GET", path, {}, b"")  # noqa: E731
    _record_read_outs(wire.decode_fleet(server.service, get("/decode/fleet")).body,
                      wire.decode_health(get("/decode/health")).body, server.deployment_name, seen)


async def _read_outs_http(server, seen: dict) -> None:
    _record_read_outs(await _get(server.port, "/decode/fleet"), await _get(server.port, "/decode/health"),
                      server.deployment_name, seen)


def _states_shown(seen: dict, arm: int, want: tuple) -> bool:
    """Whether both read-outs showed ``want`` in that order for ``arm``."""
    for src in ("fleet", "health"):
        states = seen.get((src, arm), [])
        dedup = [s for i, s in enumerate(states) if i == 0 or states[i - 1] != s]
        it = iter(dedup)
        if not all(w in it for w in want):
            return False
    return True


async def fleet_faults(card, fleet, base: dict) -> dict:
    """Phase 12b: install_decode_faults on replica 0 in the middle of 12a's
    first traffic: a round that hangs (evicted by the poller within the
    threshold, its rows migrated, readmitted half-open after the hang), a
    window of dropped probes (evicted and readmitted the same way), an
    induced allocator OOM (counted and migrated). Every row bit for bit its
    uninterrupted row, every stream whole, each state shown by /decode/fleet
    and /decode/health (their handlers read at each transition, the routes
    over HTTP before and after)."""
    from seldon_core_tpu_torch.engine.faults import DecodeFaultSpec, install_decode_faults

    sched = fleet.decode_scheduler
    r0 = sched.replicas[0]
    openers, sharers, budgets, want = base["rows_in"]
    seq = sched.seq_len
    transitions = []
    real_set = sched._set_replica_state  # instance attributes over the methods, removed after

    def set_state(arm, state, reason=""):
        transitions.append((arm, state, time.perf_counter()))
        real_set(arm, state, reason)
        _read_outs_now(fleet, seen)

    seen = {}
    sched._set_replica_state = set_state
    probes = []
    real_probe = sched._probe_ok

    def probe_ok(arm, r):
        ok = real_probe(arm, r)
        probes.append((arm, ok, time.perf_counter()))
        return ok

    sched._probe_ok = probe_ok
    out = {}
    try:
        for label, spec in (("hang", DecodeFaultSpec(hang_at_round=6, hang_s=FLEET_HANG_S)),
                            ("drop_health", DecodeFaultSpec(drop_health_from=1, drop_health_count=5)),
                            ("oom", DecodeFaultSpec(oom_at_round=6))):
            seen.clear()
            await _read_outs_http(fleet, seen)
            ev0, mig0, rec0 = sched.stat_evictions, sched.stat_migrations, sched.stat_recoveries
            del transitions[:], probes[:]
            hang_at = []
            if label == "hang":
                real_chaos = r0._chaos_round

                async def chaos(real_chaos=real_chaos):
                    if state.rounds + 1 == state.spec.hang_at_round:
                        hang_at.append(time.perf_counter())
                    await real_chaos()

                r0._chaos_round = chaos
            state = install_decode_faults(r0, spec)
            replies, _ = await fleet_traffic(fleet.port, openers, sharers, budgets[:FLEET_GROUPS],
                                             budgets[FLEET_GROUPS:])
            rows = fleet_rows(f"fleet 12b {label}", replies, budgets, seq)
            bad = [i for i, (a, b) in enumerate(zip(rows, want)) if (a != b).any()]
            if bad:
                raise AssertionError(f"fleet 12b {label}: rows {bad} differ from their uninterrupted rows")
            for _ in range(400):  # readmission
                if sched.replica_states()[0] == "up" and any(s == "up" for a, s, _ in transitions if a == 0):
                    break
                await asyncio.sleep(0.01)
            await _read_outs_http(fleet, seen)
            r0.__dict__.pop("_chaos_round", None)
            r0._faults = None
            evicted = [t for a, s, t in transitions if a == 0 and s == "evicted"]
            readmitted = [t for a, s, t in transitions if a == 0 and s == "up"]
            row = dict(injected=state.injected, evictions=sched.stat_evictions - ev0,
                       migrations=sched.stat_migrations - mig0, recoveries=sched.stat_recoveries - rec0,
                       states_shown=_states_shown(seen, 0, ("up", "evicted", "up")))
            if evicted and hang_at:
                row["evicted_after_hang_ms"] = round((evicted[0] - hang_at[0]) * 1e3, 3)
                miss = [t for a, ok, t in probes if a == 0 and not ok and t >= hang_at[0]]
                row["evicted_after_first_miss_ms"] = round((evicted[0] - miss[0]) * 1e3, 3)
            if evicted and readmitted:
                row["readmitted_after_ms"] = round((readmitted[-1] - evicted[0]) * 1e3, 3)
            out[label] = row
            # a dropped probe evicts a replica that may be between rows; a
            # hang and an OOM strike with rows in flight
            if (row["injected"] < 1 or row["evictions"] != 1 or row["recoveries"] != 1 or not row["states_shown"]
                    or (label != "drop_health" and row["migrations"] < 1)):
                raise AssertionError(f"fleet 12b {label}: {row}; states seen {seen}")
            if label == "hang":
                poll_ms = sched.health_poll_s * 1e3
                limit = (sched.health_miss_threshold + 1) * poll_ms + FLEET_EVICT_SLACK_MS
                if (row.get("evicted_after_hang_ms", limit + 1) > limit
                        or row["evicted_after_first_miss_ms"] > sched.health_miss_threshold * poll_ms):
                    raise AssertionError(f"fleet 12b: the hung replica was evicted {row} after its hang (limit "
                                         f"{limit} ms) and its first missed probe (limit "
                                         f"{sched.health_miss_threshold * poll_ms} ms)")
    finally:
        del sched._set_replica_state, sched._probe_ok
    print(f"[{card}] fleet 12b faults on replica 0 (poll {sched.health_poll_s * 1e3} ms, threshold "
          f"{sched.health_miss_threshold}): {json.dumps(out)}", flush=True)
    return out


async def _one_migration(fleet, prompt, budget: int, k: int, plant=None) -> dict:
    """One request on an idle fleet, its replica failing (an induced OOM)
    after k streamed tokens: (row, stream, wall ms); its arm readmitted
    after. ``plant`` (replicas) -> undo, a fault planted on the survivors."""
    from seldon_core_tpu_torch.engine.faults import DecodeFaultSpec, install_decode_faults

    sched = fleet.decode_scheduler
    arm = sched.route(prompt)[0]
    victim = sched.replicas[arm]
    streamed = []

    def on_token(tok, idx):
        streamed.append((int(tok), idx))
        if idx == k - 1:
            install_decode_faults(victim, DecodeFaultSpec(oom_at_round=1))

    if k == 0:
        install_decode_faults(victim, DecodeFaultSpec(oom_at_round=1))
    undo = plant([r for i, r in sched.live_replicas if i != arm]) if plant else None
    t0 = time.perf_counter()
    try:
        out = await sched.submit(prompt, max_new_tokens=budget, on_token=on_token)
    finally:
        if undo:
            undo()
    wall = (time.perf_counter() - t0) * 1e3
    victim._faults = None
    for _ in range(200):
        await asyncio.sleep(0.01)
        if sched.replica_states()[arm] == "up":
            break
    else:
        raise AssertionError(f"replica {arm} not readmitted after its OOM")
    return {"ids": list(map(int, out)), "events": [{"token": t, "index": i} for t, i in streamed], "wall_ms": wall}


def _replay_one_fewer(replicas):
    reals = {}
    for r in replicas:
        reals[r] = r.submit

        async def submit(prompt, real=r.submit, **kw):
            if kw.get("_replay_tokens"):
                kw["_replay_tokens"] = kw["_replay_tokens"][:-1]
            return await real(prompt, **kw)

        r.submit = submit
    return lambda: [r.__dict__.pop("submit") for r in reals]


def _restream_replay(replicas):
    for r in replicas:
        def planted(seq, tok, r=r, real=r._emit_inner):
            idx = len(seq.tokens)
            out = real(seq, tok)
            if idx < seq.emit_base and seq.on_token is not None:
                seq.on_token(out, idx)
            return out

        r._emit_inner = planted
    return lambda: [r.__dict__.pop("_emit_inner") for r in replicas]


async def fleet_migration_cost(card, fleet, base: dict) -> dict:
    """The resume on both loops: a request whose replica dies after k
    streamed tokens (k = 0, 1, 16 and the budget's last) ends bit for bit
    its uninterrupted row with its stream whole; its wall against the same
    request uninterrupted on the idle fleet is the migration's cost. A
    resume replaying one token fewer and one re-streaming the replay must
    each fail the stream check."""
    import numpy as np

    sched = fleet.decode_scheduler
    seq = sched.seq_len
    openers, _, budgets, want = base["rows_in"]
    prompt, budget = openers[0], sched.max_new_tokens
    out = {}
    for loop in ("pipelined", "serial"):
        for _, r in sched.live_replicas:
            r.pipeline_enabled = loop == "pipelined"
        t0 = time.perf_counter()
        clean = await sched.submit(prompt, max_new_tokens=budget)
        plain_ms = (time.perf_counter() - t0) * 1e3
        costs = {}
        for k in (0, 1, 16, budget - 1):
            got = await _one_migration(fleet, prompt, budget, k)
            stream_check(f"fleet migration {loop} k={k}", got, seq)
            if got["ids"] != list(map(int, clean)):
                raise AssertionError(f"fleet migration {loop} k={k}: the resumed row differs from the "
                                     "uninterrupted one")
            costs[k] = round(got["wall_ms"] - plain_ms, 3)
        out[loop] = {"uninterrupted_ms": round(plain_ms, 3), "migration_cost_ms": costs}
    for _, r in sched.live_replicas:
        r.pipeline_enabled = True
    if not np.array_equal(np.asarray(clean[: seq + budgets[0]]), want[0][: seq + budgets[0]]):
        raise AssertionError("fleet migration: the idle fleet's row differs from 12a's")
    for label, plant in (("a resume that replays one token fewer", _replay_one_fewer),
                         ("a resume that re-streams the replayed tokens", _restream_replay)):
        got = await _one_migration(fleet, prompt, budget, 16, plant)
        must_fail(label, lambda got=got: stream_check(label, got, seq))
    print(f"[{card}] fleet migration (one request, budget {budget}, idle fleet; replica killed after k tokens): "
          f"{json.dumps(out)}; a replay one token short and a re-streamed replay failed the stream check",
          flush=True)
    return out


async def fleet_drain(card, fleet, one8, base: dict) -> dict:
    """Phase 12c: POST /decode/drain?replica=1 under 12a's traffic: the
    replica's in-flight rows finish or migrate (every row bit for bit), its
    prefix pages go to its rendezvous sibling (a later request of one of
    its system prompts is a device hit there), it ends ``down``. A
    ``?replica=x`` answers 400 naming the parameter; on a deployment
    without a fleet /decode/fleet answers 404 and /decode/drain 400."""
    sched = fleet.decode_scheduler
    seq = sched.seq_len
    openers, sharers, budgets, want = base["rows_in"]
    home1 = [g for g in range(FLEET_GROUPS) if sched.route(openers[g])[0] == 1]
    if not home1:
        raise AssertionError("fleet 12c: no system prompt homes on replica 1")
    traffic = asyncio.ensure_future(fleet_traffic(fleet.port, openers, sharers, budgets[:FLEET_GROUPS],
                                                  budgets[FLEET_GROUPS:]))
    await asyncio.sleep(0.06)  # the sharers are in flight
    status, _, body, drain_ms = await _request(fleet.port, b"", path="/decode/drain?replica=1")
    drained = json.loads(body)
    replies, _ = await traffic
    if status != 200 or drained.get("replica") != 1 or sched.replica_states()[1] != "down":
        raise AssertionError(f"fleet 12c: drain answered {status} {drained}, states {sched.replica_states()}")
    rows = fleet_rows("fleet 12c", replies, budgets, seq)
    bad = [i for i, (a, b) in enumerate(zip(rows, want)) if (a != b).any()]
    if bad:
        raise AssertionError(f"fleet 12c: rows {bad} differ from their uninterrupted rows")
    prompt = sharers[home1[0] * (FLEET_PER_GROUP - 1)].copy()
    prompt[-1] = (prompt[-1] + 1) % int(_model_runtime(fleet).params["tok_emb"].shape[0])
    r0 = sched.replicas[0]
    c0 = (r0.stat_prefix_hits, r0.stat_prefix_misses, sched.stat_sibling_pulls)
    status, _, body, _ = await _ids_post(fleet.port, prompt[None], {"max_new_tokens": 4})
    c1 = (r0.stat_prefix_hits, r0.stat_prefix_misses, sched.stat_sibling_pulls)
    if status != 200 or (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) != (1, 0, 0):
        raise AssertionError(f"fleet 12c: a request of a drained system prompt on replica 0: HTTP {status}, "
                             f"(hits, misses, pulls) moved by {[b - a for a, b in zip(c0, c1)]}")
    codes = {}
    for label, port, method, path, want_status, want_body in (
            ("bad replica", fleet.port, "POST", "/decode/drain?replica=x", 400,
             {"error": "?replica must be an integer arm id", "param": "replica", "got": "x"}),
            ("no fleet: read-out", one8.port, "GET", "/decode/fleet", 404, {"error": "no replicated decode tier"}),
            ("no fleet: drain", one8.port, "POST", "/decode/drain", 400,
             {"error": "ENGINE_INVALID_JSON(101): Invalid JSON deployment has no replicated decode tier to drain"})):
        got_status, _, got_body, _ = await _request(port, b"", path=path, method=method)
        codes[label] = got_status
        if (got_status, json.loads(got_body)) != (want_status, want_body):
            raise AssertionError(f"fleet 12c {label}: {got_status} {got_body!r}, want {want_status} {want_body}")
    row = dict(drain=drained, drain_ms=round(drain_ms, 3), pushed_group_hit_on_r0=True, codes=codes,
               states=sched.replica_states())
    print(f"[{card}] fleet 12c drain of replica 1 under traffic: {json.dumps(row)}", flush=True)
    return row


async def fleet_scale_up(card, fleet, base: dict, store: Path) -> dict:
    """Phase 12d: traffic that holds replica 0's queue above the autoscale
    depth boots replica 2, pre-seeded from a spill written to and read back
    from the file:// store: its pages' bytes the exported bytes (and replica
    0's where it still holds the entry), its first request of a spilled
    system prompt a prefix hit, no dispatch key after its warmup; its boot
    split, the growth of memory_reserved() over the scale-up. A preseed
    written one page off must fail the byte check."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.persistence.state import FileStateStore
    from seldon_core_tpu_torch.serving.affinity_router import _key_rank, prefix_route_key, spill_key

    sched = fleet.decode_scheduler
    seq = sched.seq_len
    openers, sharers, budgets, want = base["rows_in"]
    prompts = np.concatenate([openers, sharers])
    payloads = []
    real_build = sched._build_warm_replica

    def build(rid, payload):
        payloads.append(payload)
        return real_build(rid, payload)

    sched._build_warm_replica = build
    on_card = DEVICE == "cuda"

    def held() -> int:
        """memory_reserved() with the caching allocator's free blocks
        released first (a capture's torch.cuda.graph releases them too)."""
        if not on_card:
            return 0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    reserved0 = held()
    pending, t0, k = [], time.perf_counter(), 0
    try:
        while not sched._scaling and len(sched.replicas) < 3:
            if time.perf_counter() - t0 > FLEET_SCALE_LIMIT_S:
                raise AssertionError(f"fleet 12d: no scale-up in {FLEET_SCALE_LIMIT_S} s (queue depth "
                                     f"{sched.queue_depth})")
            for _ in range(max(0, 2 * sched.autoscale_queue_depth - sched.queue_depth)):
                pending.append(asyncio.ensure_future(_ids_post(fleet.port, prompts[k % len(prompts)][None],
                                                               {"max_new_tokens": sched.max_new_tokens})))
                k += 1
            await asyncio.sleep(FLEET_SCALE_EVERY_S)
        triggered = time.perf_counter() - t0
        depth_at_trigger = sched.queue_depth
        task = sched._scale_task
        if task is not None:
            await task
        replies = await asyncio.gather(*pending)
    finally:
        del sched._build_warm_replica
    grew = held() - reserved0
    failed = [(status, body[:200]) for status, _, body, _ in replies if status != 200]
    if failed or len(sched.replicas) != 3 or sched.replicas[2] is None:
        raise AssertionError(f"fleet 12d: scale-up failed (replicas {sched.replica_states()}, boot failures "
                             f"{sched.stat_boot_failures}, failed requests {failed[:3]} of {len(failed)})")
    new = sched.replicas[2]
    payload = payloads[0]
    saved = FileStateStore(str(store)).load(spill_key(sched._deployment))
    if not payload or not payload["entries"] or saved is None or new.stat_prefix_preseeded < 1:
        raise AssertionError(f"fleet 12d: no spill reached replica 2 (store file {saved is not None}, "
                             f"preseeded {new.stat_prefix_preseeded})")

    def byte_check(sched_, payload_) -> int:
        """Every seeded entry's pages hold the payload's bytes."""
        n = 0
        for e in payload_["entries"]:
            span = np.asarray(e["tokens"])
            ent, depth = sched_._prefix_index.match(span, touch=False)
            if ent is None or depth < len(ent.tokens):
                continue
            with sched_._on_stream():
                got = sched_.pool.read_pages(ent.pages)
            for g, w in zip(got, e["components"]):
                if not np.array_equal(g, w[:, : len(ent.pages)]):
                    raise AssertionError(f"a preseeded entry's pages differ from the spilled bytes ({len(span)} "
                                         "tokens)")
            n += 1
        if n < 1:
            raise AssertionError("no spilled entry found in the pool")
        return n

    checked = byte_check(new, payload)
    same_as_home = 0
    home = sched.replicas[0]
    for e in payload["entries"]:
        ent, depth = home._prefix_index.match(np.asarray(e["tokens"]), touch=False)
        ent2, _ = new._prefix_index.match(np.asarray(e["tokens"]), touch=False)
        if ent is None or ent2 is None or depth < len(ent.tokens) or len(ent.pages) != len(ent2.pages):
            continue
        with home._on_stream():
            a = home.pool.read_pages(ent.pages)
        with new._on_stream():
            b = new.pool.read_pages(ent2.pages)
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("a preseeded entry's pages differ from the home replica's")
        same_as_home += 1
    # planted: a preseed written one page off
    plant = sched.factory(99)
    real_write = plant.pool.write_pages
    plant.pool.write_pages = lambda pages, comps: real_write([p + 1 for p in pages], comps)
    plant.preseed_prefix_state(payload)
    must_fail("a preseed written one page off", lambda: byte_check(plant, payload))
    from seldon_core_tpu_torch.telemetry import flight

    flight._RECORDERS.pop(plant.flight.name, None)
    del plant
    # the new replica's first request of a spilled system prompt
    spilled = [np.asarray(e["tokens"]) for e in payload["entries"]]
    mine = [t for t in spilled
            if max((0, 2), key=lambda a: _key_rank(prefix_route_key(t, block=sched.affinity_block, seq_len=seq),
                                                   a)) == 2]
    src = mine[0] if mine else spilled[0]
    g = next(i for i, p in enumerate(prompts) if np.array_equal(p[: len(src)], src))
    prompt = prompts[g].copy()
    prompt[-1] = (prompt[-1] + 3) % int(_model_runtime(fleet).params["tok_emb"].shape[0])
    c0 = (new.stat_prefix_hits, new.stat_prefix_misses)
    if mine:
        status, _, body, _ = await _ids_post(fleet.port, prompt[None], {"max_new_tokens": 4})
        via = "REST (routed to replica 2)"
    else:
        await new.submit(prompt, max_new_tokens=4)
        status, via = 200, "replica 2 directly (no spilled system prompt homes on it)"
    if status != 200 or (new.stat_prefix_hits - c0[0], new.stat_prefix_misses - c0[1]) != (1, 0):
        raise AssertionError(f"fleet 12d: replica 2's first request of a spilled system prompt was no prefix hit")
    if new.recompiles_since_warmup() != 0 or sched.recompiles_since_warmup() != 0:
        raise AssertionError("fleet 12d: dispatch keys after warmup")
    row = dict(triggered_after_s=round(triggered, 3), queue_depth_at_trigger=depth_at_trigger,
               requests=len(replies), boot_s={k: round(v, 3) for k, v in new.boot_split.items()},
               spilled_entries=len(payload["entries"]), preseeded=new.stat_prefix_preseeded,
               bytes_checked=checked, equal_to_home=same_as_home, first_request=via,
               reserved_growth_mib=round(grew / 2**20, 1), pool_mib=round(_pool_bytes(new) / 2**20, 1),
               states=sched.replica_states())
    print(f"[{card}] fleet 12d warm scale-up: {json.dumps(row)}; a preseed written one page off failed the byte "
          f"check", flush=True)
    return row


async def serve_fleet(card) -> dict:
    """Phase 12: the replicated decode fleet (gpt2_small_replicated: two
    GPT-2-small replicas of 8 slots sharing the card's parameters, the
    affinity router, health polling at 20 ms) through REST on the pipelined
    loop, beside one-replica copies at 8 and at 16 slots (16 slots get
    twice the pages and prefix entries): 12a routing and rows, 12b eviction
    and migration, 12c drain, 12d warm scale-up, and the planted faults of
    each. Neither kernel launches (counted)."""
    import shutil

    from seldon_core_tpu_torch.ops import int8_matmul
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.utils.env import PERSISTENCE_STORE

    t0 = time.perf_counter()
    store = ROOT / FLEET_STORE
    shutil.rmtree(store, ignore_errors=True)
    os.environ[PERSISTENCE_STORE] = f"file://{store}"
    launches0, int8_0 = LAUNCHES.count, int8_matmul.LAUNCHES.count
    tpu = json.loads((BASELINE_DIR / "gpt2_small_replicated.json").read_text())["spec"]["predictors"][0]["tpu"]
    fleet, fleet_build, fleet_warm = await _start_fleet(BASELINE_DIR / "gpt2_small_replicated.json")
    one8, *_ = await _start(_one_replica_copy(tpu["decode_slots"], tpu["decode_kv_pages"], tpu["decode_prefix_slots"]))
    one16, *_ = await _start(_one_replica_copy(2 * tpu["decode_slots"], 2 * tpu["decode_kv_pages"],
                                               2 * tpu["decode_prefix_slots"]))
    sched = fleet.decode_scheduler
    params = _cpu_params(_model_runtime(fleet))
    memory = {"replica_warmup_mib": {i: round(b / 2**20, 1) for i, b in fleet.replica_warmup_bytes.items()},
              "replica_pool_mib": {i: round(_pool_bytes(r) / 2**20, 1) for i, r in sched.live_replicas},
              "one8_warmup_mib": round(one8.warmup_reserved_bytes / 2**20, 1),
              "one16_warmup_mib": round(one16.warmup_reserved_bytes / 2**20, 1)}
    print(f"[{card}] phase 12 fleet built in {fleet_build:.3f} s, warmed in {fleet_warm:.3f} s; replicas share the "
          f"parameters: {all(r.params is _model_runtime(fleet).params for _, r in sched.live_replicas)}; memory "
          f"{json.dumps(memory)}", flush=True)
    try:
        runs = await fleet_runs(card, fleet, one8, one16, params)
        base = {"rows_in": runs.pop("rows")}
        faults = await fleet_faults(card, fleet, base)
        migration = await fleet_migration_cost(card, fleet, base)
        drain = await fleet_drain(card, fleet, one8, base)
        scale = await fleet_scale_up(card, fleet, base, store)
        sched.allocator_audits()
    finally:
        for srv in (fleet, one8, one16):
            await srv.stop()
        os.environ.pop(PERSISTENCE_STORE, None)
    launches = {"flash_attention": LAUNCHES.count - launches0, "int8_matmul": int8_matmul.LAUNCHES.count - int8_0}
    print(f"[{card}] phase 12 launches: {json.dumps(launches)}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"the fleet launched a kernel: {launches}")
    return {"memory": memory, "runs": runs, "faults": faults, "migration": migration, "drain": drain,
            "scale_up": scale, "launches": launches, "seconds": round(time.perf_counter() - t0, 3)}


# ---------------------------------------------------------------- phase 13
SPLIT_DIR = ROOT / "build" / "split_dag"  # git-ignored: the arms' deployments and a router class, written per run
GATE_KEY, GATE_SECRET = "bert-flash-key", "bert-flash-secret"  # bert_base_flash declares no OAuth client
GATE_REQUESTS = 20  # one-row requests through the gateway, each also sent to the predictor's ingress
SPLIT_REQUESTS = 16  # one-row requests to the split DAG and the in-process DAG, in turns
SPLIT_FAULT_REQUESTS = 6
MALFORMED = 5  # 400s a unit server answers before the breaker check
SPLIT_LOAD = (1, 16)  # users: the 1-user latency and the 16-user rate
SPLIT_TURNS = ("a", "b", "b", "a")
CONTRACT_ROUNDS = 4
CONTRACT_BATCH = 8
UNIT_BOOT_S = 300.0
MNIST_CNN_DIR = "seldon_core_tpu_torch/examples/models/torch_mnist_cnn"


def _arm_deployment(arm: dict, name: str) -> Path:
    """One arm of full_dag_bert.json as a deployment of its own (its graph
    node, the DAG's tpu block): the weights of that arm, served alone."""
    dag = json.loads((BASELINE_DIR / "full_dag_bert.json").read_text())
    pred = dag["spec"]["predictors"][0]
    dep = {"metadata": {"name": name}, "spec": {"name": name, "predictors": [
        {"name": "main", "graph": arm, "tpu": pred["tpu"]}]}}
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    path = SPLIT_DIR / f"{name}.json"
    path.write_text(json.dumps(dep, indent=1))
    return path


def _dag_arms() -> list:
    dag = json.loads((BASELINE_DIR / "full_dag_bert.json").read_text())
    return dag["spec"]["predictors"][0]["graph"]["children"][0]["children"]


def _remote_copy(ports: list, label: str, arm_params: tuple = (), etype: str = "REST") -> Path:
    """full_dag_bert_remote.json with the arms' ports (and endpoint type)
    written in."""
    dep = json.loads((BASELINE_DIR / "full_dag_bert_remote.json").read_text())
    arms = dep["spec"]["predictors"][0]["graph"]["children"][0]["children"]
    for arm, port in zip(arms, ports):
        arm["endpoint"]["service_port"] = port
        arm["endpoint"]["type"] = etype
        arm["parameters"] = list(arm_params)
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    path = SPLIT_DIR / f"full_dag_bert_remote_{label}.json"
    path.write_text(json.dumps(dep, indent=1))
    return path


async def _spawn(args: list, label: str, env: dict | None = None, cwd: Path = ROOT):
    """A child process of this Python (its own CUDA context on the card),
    returned once it prints its "serving ..." line, with the REST port of
    that line (None when it serves none); the gRPC port, if it names one,
    is the process's ``grpc_port``."""
    proc = await asyncio.create_subprocess_exec(sys.executable, "-m", *args, stdout=asyncio.subprocess.PIPE,
                                                stderr=asyncio.subprocess.STDOUT, cwd=str(cwd),
                                                env=None if env is None else {**os.environ, **env})
    lines = []

    async def until_serving():
        while True:
            line = (await proc.stdout.readline()).decode(errors="replace")
            if not line:
                raise AssertionError(f"{label} exited {await proc.wait()} before serving: {''.join(lines)[-2000:]}")
            lines.append(line)
            if " serving " in line and re.search(r"(REST|gRPC) :\d+", line):
                grpc_port = re.search(r"gRPC :(\d+)", line)
                proc.grpc_port = int(grpc_port.group(1)) if grpc_port else None
                rest = re.search(r"REST :(\d+)", line)
                return int(rest.group(1)) if rest else None

    t0 = time.perf_counter()
    try:
        port = await asyncio.wait_for(until_serving(), UNIT_BOOT_S)
    except BaseException:
        await _reap(proc)
        raise
    # keep draining its output, so a chatty child never blocks on a full pipe
    proc.drain_task = asyncio.ensure_future(proc.stdout.read())
    return proc, port, time.perf_counter() - t0


async def _reap(proc) -> None:
    if proc.returncode is None:
        proc.terminate()
        try:
            await asyncio.wait_for(proc.wait(), 30)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
    task = getattr(proc, "drain_task", None)
    if task is not None:
        await asyncio.gather(task, return_exceptions=True)


async def _bearer_post(port: int, token: str, body: bytes, path: str = "/api/v0.1/predictions", headers=None):
    status, hdrs, payload, ms = await _request(port, body, path=path,
                                               headers={"Authorization": f"Bearer {token}", **(headers or {})})
    return status, payload, ms


async def _token(port: int, how: str, key: str, secret: str) -> str:
    """A client_credentials token from the gateway, by Basic auth or by an
    urlencoded form."""
    import base64
    from urllib.parse import urlencode

    if how == "basic":
        basic = base64.b64encode(f"{key}:{secret}".encode()).decode()
        status, _, body, _ = await _request(port, b"grant_type=client_credentials",
                                            "application/x-www-form-urlencoded", "/oauth/token",
                                            headers={"Authorization": f"Basic {basic}"})
    else:
        form = urlencode({"grant_type": "client_credentials", "client_id": key, "client_secret": secret})
        status, _, body, _ = await _request(port, form.encode(), "application/x-www-form-urlencoded", "/oauth/token")
    if status != 200:
        raise AssertionError(f"token by {how}: HTTP {status} {body[:200]!r}")
    return json.loads(body)["access_token"]


async def _refused(port: int, token: str | None, want_status: int, want_code: int, label: str) -> None:
    body = json.dumps({"data": {"ndarray": [[0.0] * 8]}}).encode()
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    status, _, payload, _ = await _request(port, body, headers=headers)
    out = json.loads(payload)
    if status != want_status or out.get("code") != want_code or out.get("status") != "FAILURE":
        raise AssertionError(f"{label}: HTTP {status} {out}, want {want_status} code {want_code}")


async def rotation_refusal(gw, port: int, label: str) -> None:
    """Key rotation: the deployment's old key must stop routing and its
    tokens must stop authenticating (401, APIFE_GRPC_NO_PRINCIPAL_FOUND)."""
    from seldon_core_tpu_torch.graph.spec import DeploymentSpec

    dep = gw.store.by_principal(GATE_KEY)
    old = await _token(port, "form", GATE_KEY, GATE_SECRET)
    gw.store.deployment_added(DeploymentSpec(name=dep.name, oauth_key=GATE_KEY + "-2", oauth_secret=GATE_SECRET,
                                             predictors=dep.predictors))
    try:
        await _refused(port, old, 401, 205, f"{label}: a token of the rotated-out key")
        await _token(port, "form", GATE_KEY + "-2", GATE_SECRET)
    finally:
        gw.store.deployment_added(dep)  # back to the first key


async def must_fail_async(label: str, fn) -> None:
    """A planted fault in an async check: the check must raise."""
    try:
        await fn()
    except AssertionError:
        return
    raise AssertionError(f"planted fault passed its check: {label}")


async def _gate_points(card, label: str, port: int, load: dict) -> dict:
    out = {}
    for users in SPLIT_LOAD:
        p = await _load_point(port, users, load)
        print(f"[{card}] load {label} users={users} {json.dumps(p)}", flush=True)
        out[users] = p
    return out


def _turns_summary(runs: dict) -> dict:
    """Per arm of the comparison, its two runs' 1-user p50/p99 and 16-user
    predictions/s."""
    return {name: {"p50_ms_users_1": [r[1]["p50_ms"] for r in rs], "p99_ms_users_1": [r[1]["p99_ms"] for r in rs],
                   "predictions_per_s_users_16": [r[16]["requests_per_sec"] for r in rs]}
            for name, rs in runs.items()}


async def gateway_in_front(card, boots) -> dict:
    """Phase 13a: bert_base_flash behind the port's OAuth gateway
    (tools/stack.build_gateway_stack, a file:// audit sink), the gateway's
    routes on their own port beside the predictor's ingress. Tokens by
    Basic auth and by form; GATE_REQUESTS one-row Bearer requests, each
    answer bit for bit the same request's answer from the predictor's own
    ingress and 12 flash launches each; the audit read back by
    tools/audit_tail; the load generator with --oauth-key against the
    gateway and without against the ingress, in turns, with a third arm,
    the gateway with its audit sink off, beside them (the phase's other
    processes have finished booting first: ``boots``); then the refusals:
    a missing token, a wrong secret, a token of a rotated-out key (and a
    gateway planted to skip that revocation must fail the check), a
    deployment whose engine is gone and one removed from the store."""
    import numpy as np

    from seldon_core_tpu_torch.gateway import NullAuditSink, make_audit_sink
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
    from seldon_core_tpu_torch.serving.server import load_predictor
    from seldon_core_tpu_torch.tools import audit_tail
    from seldon_core_tpu_torch.tools.stack import build_gateway_stack

    audit_dir = SPLIT_DIR / "audit"
    if audit_dir.exists():
        for f in audit_dir.iterdir():
            f.unlink()
    predictor, name = load_predictor(str(BASELINE_DIR / "bert_base_flash.json"))
    t0 = time.perf_counter()
    server, gw, _, _ = build_gateway_stack(predictor, deployment_name=name, oauth_key=GATE_KEY,
                                           oauth_secret=GATE_SECRET, audit=make_audit_sink(f"file://{audit_dir}"),
                                           device=DEVICE)
    boot_s = time.perf_counter() - t0
    runtime = _model_runtime(server)
    seq, vocab, layers = runtime.feature_shape[0], runtime.params["tok_emb"].shape[0], len(runtime.params["layers"])
    await server.start("127.0.0.1", 0)
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    gport = gws.sockets[0].getsockname()[1]
    rng = np.random.default_rng(13)
    row = {"boot_s": round(boot_s, 3)}
    try:
        token = await _token(gport, "basic", GATE_KEY, GATE_SECRET)
        form_token = await _token(gport, "form", GATE_KEY, GATE_SECRET)
        sent, received, deltas, ms = [], [], [], {"gateway": [], "direct": []}
        for i in range(GATE_REQUESTS):
            ids = rng.integers(0, vocab, size=(1, seq))
            body = json.dumps({"data": {"ndarray": ids.tolist()}}).encode()
            before = LAUNCHES.count
            status, gate_raw, gate_ms = await _bearer_post(gport, token if i % 2 else form_token, body)
            deltas.append(LAUNCHES.count - before)
            before = LAUNCHES.count
            d_status, _, direct_raw, direct_ms = await _request(server.port, body)
            deltas.append(LAUNCHES.count - before)
            if (status, d_status) != (200, 200):
                raise AssertionError(f"13a request {i}: gateway HTTP {status}, ingress HTTP {d_status}: {gate_raw[:200]!r}")
            gate, direct = json.loads(gate_raw), json.loads(direct_raw)
            _check_probs(gate, 1)
            if gate["data"] != direct["data"]:
                raise AssertionError(f"13a request {i}: the gateway answered {gate['data']}, the ingress "
                                     f"{direct['data']}")
            sent.append(ids)
            received.append(gate)
            ms["gateway"].append(gate_ms)
            ms["direct"].append(direct_ms)
        require_launches("13a bert_base_flash (gateway and ingress) flash_attention", deltas, layers)
        print(f"[{card}] 13a {GATE_REQUESTS} requests through the gateway bit for bit the ingress's; launches "
              f"{sum(deltas)} ({layers} a request); one-request wall ms gateway {_mean([{'ms': m} for m in ms['gateway']])} "
              f"direct {_mean([{'ms': m} for m in ms['direct']])}", flush=True)
        records = list(audit_tail.iter_records(f"file://{audit_dir}", GATE_KEY, follow=False))
        if len(records) != GATE_REQUESTS:
            raise AssertionError(f"13a audit: {len(records)} records, want {GATE_REQUESTS}")
        for i, (rec, ids, out) in enumerate(zip(records, sent, received)):
            if np.asarray(rec["request"]["data"]["ndarray"], np.float32).tolist() != ids.astype(np.float32).tolist():
                raise AssertionError(f"13a audit record {i}: the request is not the one sent")
            if rec["response"] != out:
                raise AssertionError(f"13a audit record {i}: the response is not the one received")
        print(f"[{card}] 13a audit: {len(records)} records read back by tools/audit_tail, each request and "
              f"response the pair sent and received", flush=True)
        await boots()  # the unit servers and the microservice boot off the measured window
        runs = {"gateway": [], "gateway_audit_off": [], "direct": []}
        gate_load = {"payload": "json", "features": seq, "oauth": (GATE_KEY, GATE_SECRET)}
        audit = gw.audit
        for turn in ("gateway", "gateway_audit_off", "direct"):
            gw.audit = NullAuditSink() if turn == "gateway_audit_off" else audit
            if turn == "direct":
                runs[turn].append(await _gate_points(card, "13a direct", server.port, {"payload": "json",
                                                                                      "features": seq}))
            else:
                runs[turn].append(await _gate_points(card, f"13a {turn}", gport, gate_load))
        gw.audit = audit
        row["load"] = _turns_summary(runs)
        row["keys_after_warmup"] = runtime.recompiles_since_warmup()
        if row["keys_after_warmup"]:
            raise AssertionError(f"13a: {row['keys_after_warmup']} new dispatch keys after warmup")
        # the refusals, each with the JAX gateway's status and code
        await _refused(gport, None, 401, 205, "13a a missing token")
        from urllib.parse import urlencode

        form = urlencode({"grant_type": "client_credentials", "client_id": GATE_KEY, "client_secret": "wrong"})
        status, _, body, _ = await _request(gport, form.encode(), "application/x-www-form-urlencoded", "/oauth/token")
        if status != 401 or json.loads(body).get("error") != "invalid_client":
            raise AssertionError(f"13a a wrong secret: HTTP {status} {body!r}")
        await rotation_refusal(gw, gport, "13a")

        # planted: a gateway whose key rotation forgets the old key's tokens
        gw.oauth.remove_client = lambda client_id: gw.oauth._clients.pop(client_id, None)
        try:
            await must_fail_async("13a a gateway that skips token revocation on key rotation",
                                  lambda: rotation_refusal(gw, gport, "13a planted"))
        finally:
            del gw.oauth.remove_client
        token = await _token(gport, "basic", GATE_KEY, GATE_SECRET)  # the rotations revoked the first
        backend = gw.backend
        backend.unregister(name)
        await _refused(gport, token, 500, 204, "13a a deployment whose engine is gone")
        backend.register(name, server.service)
        gw.store.deployment_removed(name)
        await _refused(gport, token, 401, 205, "13a a removed deployment's token")
    finally:
        gws.close()
        await server.stop()
    row["launches"] = sum(deltas)
    return row


def hold_split(label: str, pairs: list) -> None:
    """Each (split reply, in-process reply): the same route and the same
    probabilities, bit for bit (float32 goes through JSON as the shortest
    repr of its float64 widening, which reads back to the same float32)."""
    for i, (a, b) in enumerate(pairs):
        if a["meta"].get("routing") != b["meta"].get("routing"):
            raise AssertionError(f"{label} request {i}: routed {a['meta'].get('routing')} against "
                                 f"{b['meta'].get('routing')}")
        if a["data"] != b["data"]:
            import numpy as np

            gap = float(np.abs(np.asarray(a["data"]["ndarray"]) - np.asarray(b["data"]["ndarray"])).max())
            raise AssertionError(f"{label} request {i}: probabilities differ by {gap}")


def sync_router(dst, src) -> None:
    """Give an epsilon-greedy router another's state (its draws to come,
    its counts and rewards)."""
    dst._rng.setstate(src._rng.getstate())
    dst.counts, dst.rewards = list(src.counts), list(src.rewards)


def breaker_check(label: str, ex, unit: str, answers: list) -> None:
    """After the unit server answered 400 to each malformed body, the
    endpoint's breaker is still closed."""
    if not all("-> 400" in a for a in answers):
        raise AssertionError(f"{label}: the unit server's answers were {answers}, want 400s")
    state = ex.breaker_for(unit).state
    if state != "closed":
        raise AssertionError(f"{label}: {len(answers)} answers of 400 left the breaker {state}")


async def _malformed_answers(ex) -> list:
    from seldon_core_tpu_torch.core.errors import APIException
    from seldon_core_tpu_torch.core.message import SeldonMessage

    answers = []
    for _ in range(MALFORMED):
        try:
            await ex.execute(SeldonMessage(str_data="malformed"))
        except APIException as e:
            answers.append(e.info)
        else:
            raise AssertionError("a malformed body was answered 200")
    return answers


def _split_trace(engine_rec: dict, unit_rec: dict, arm: str, trace_id: str, label: str = "13b") -> dict:
    """The hop in one request's trace: the engine's span around the arm's
    call against the unit server's ingress span that continues it."""
    engine_spans = [s for s in engine_rec["trace"] if s["name"].startswith(f"{arm}.")]
    roots = [s for s in unit_rec["trace"] if s["name"] == "ingress"]
    if len(engine_spans) != 1 or len(roots) != 1:
        raise AssertionError(f"{label} trace {trace_id}: engine spans {[s['name'] for s in engine_rec['trace']]}, "
                             f"unit server spans {[s['name'] for s in unit_rec['trace']]}")
    unit_span, root = engine_spans[0], roots[0]
    if root["trace_id"] != trace_id or root["parent_id"] != unit_span["span_id"]:
        raise AssertionError(f"{label} trace: the unit server's ingress span {root} does not continue the engine's "
                             f"{unit_span}")
    unit_ms = (unit_span["end_ns"] - unit_span["start_ns"]) / 1e6
    server_ms = (root["end_ns"] - root["start_ns"]) / 1e6
    return {"engine_unit_span_ms": round(unit_ms, 4), "unit_server_ingress_span_ms": round(server_ms, 4),
            "hop_ms": round(unit_ms - server_ms, 4)}


async def split_dag(card, spawns: list) -> dict:
    """Phase 13b: full_dag_bert split as the reference deploys it. Both
    BERT-base arms (seq 128, bf16, seeds 0 and 1: full_dag_bert.json's
    bert-a and bert-b) served by their own unit servers, separate processes
    on the card started through the server CLI with --warmup; the engine
    (full_dag_bert_remote.json, the ports written in) in this process
    behind the gateway with full_dag_bert's OAuth client; the same
    requests to the split DAG and to the in-process full_dag_bert in
    turns: routes and probabilities equal request by request; a feedback
    moving only the routed arm's reward; the same arms as in-process unit
    servers on their own ports behind a third engine, counted (12 flash
    launches a request); one request's engine unit span against the unit
    server's ingress span; the load generator on the split and the
    in-process DAG in turns. Planted: the arms' endpoints swapped (the
    probability check must fail), and a client counting 4xx against the
    breaker (the breaker check must fail after MALFORMED 400s)."""
    import numpy as np

    from seldon_core_tpu_torch.core.errors import APIException
    from seldon_core_tpu_torch.engine import remote
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
    from seldon_core_tpu_torch.serving.server import load_predictor
    from seldon_core_tpu_torch.tools.stack import build_gateway_stack

    names = [a["name"] for a in _dag_arms()]
    arm_paths = [SPLIT_DIR / f"{n}.json" for n in names]
    servers, gws = [], None
    row: dict = {}
    try:
        t0 = time.perf_counter()
        local, _, _ = await _start(BASELINE_DIR / "full_dag_bert.json")
        servers.append(local)
        twin_arms = []
        for p in arm_paths:
            twin, _, _ = await _start(p)
            servers.append(twin)
            twin_arms.append(twin)
        in_process_s = time.perf_counter() - t0
        done = [await task for task in spawns]
        ports = [d[1] for d in done]
        row["unit_server_boot_s"] = [round(d[2], 3) for d in done]
        row["in_process_boot_s"] = round(in_process_s, 3)
        print(f"[{card}] 13b unit servers {names} serving on ports {ports}, boot s {row['unit_server_boot_s']} "
              f"(separate processes, booted during 13a); {in_process_s:.3f} s of in-process boots here; "
              f"memory_reserved() per unit server is not read (their /metrics do not carry it)", flush=True)
        predictor, dep_name = load_predictor(str(_remote_copy(ports, "split")))
        dag = json.loads((BASELINE_DIR / "full_dag_bert.json").read_text())["spec"]
        split, gw, _, _ = build_gateway_stack(predictor, deployment_name=dep_name, oauth_key=dag["oauth_key"],
                                              oauth_secret=dag["oauth_secret"], device=DEVICE)
        await split.start("127.0.0.1", 0)
        servers.append(split)
        gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
        gport = gws.sockets[0].getsockname()[1]
        token = await _token(gport, "form", dag["oauth_key"], dag["oauth_secret"])
        twins, _, _ = await _start(_remote_copy([t.port for t in twin_arms], "twins"))
        servers.append(twins)
        local_router = local.executor.root.children[0].unit
        split_router = split.executor.root.children[0].unit
        if [type(c.unit).__name__ for c in split.executor.root.children[0].children] != ["RemoteUnit"] * 2:
            raise AssertionError("13b: the split engine's arms are not remote units")
        runtime = twin_arms[0].executor.root.unit.runtime
        seq, vocab, layers = runtime.feature_shape[0], runtime.params["tok_emb"].shape[0], len(runtime.params["layers"])
        rng = np.random.default_rng(131)
        pairs, twin_pairs, deltas, routes = [], [], [], []
        for i in range(SPLIT_REQUESTS):
            body = json.dumps({"data": {"ndarray": rng.integers(0, vocab, size=(1, seq)).tolist()}}).encode()
            status, raw, _ = await _bearer_post(gport, token, body)
            l_status, _, l_raw, _ = await _request(local.port, body)
            before = LAUNCHES.count
            t_status, _, t_raw, _ = await _request(twins.port, body)
            deltas.append(LAUNCHES.count - before)
            if (status, l_status, t_status) != (200, 200, 200):
                raise AssertionError(f"13b request {i}: split HTTP {status}, in-process {l_status}, twins {t_status}: "
                                     f"{raw[:300]!r}")
            a, b, t = json.loads(raw), json.loads(l_raw), json.loads(t_raw)
            _check_probs(a, 1)
            pairs.append((a, b))
            twin_pairs.append((t, b))
            routes.append(a["meta"]["routing"]["eg"])
        hold_split("13b split DAG against the in-process DAG", pairs)
        hold_split("13b in-process unit servers against the in-process DAG", twin_pairs)
        require_launches("13b in-process arm unit servers flash_attention", deltas, layers)
        print(f"[{card}] 13b {SPLIT_REQUESTS} requests: routes {routes} equal request by request, probabilities "
              f"bit for bit the in-process DAG's (split and in-process unit servers); {layers} flash launches a "
              f"request on the in-process unit servers ({sum(deltas)})", flush=True)
        row["routes"] = routes
        row["launches"] = sum(deltas)
        # a feedback through the gateway moves only the routed arm's reward
        route = routes[-1]
        counts, rewards = list(split_router.counts), list(split_router.rewards)
        fb = json.dumps({"response": pairs[-1][0], "reward": 1.0}).encode()
        status, raw, _ = await _bearer_post(gport, token, fb, path="/api/v0.1/feedback")
        want_counts = [c + (i == route) for i, c in enumerate(counts)]
        want_rewards = [r + (1.0 if i == route else 0.0) for i, r in enumerate(rewards)]
        if status != 200 or split_router.counts != want_counts or split_router.rewards != want_rewards:
            raise AssertionError(f"13b feedback: HTTP {status}, router {split_router.counts} {split_router.rewards}, "
                                 f"want {want_counts} {want_rewards}")
        # one request's hop, from its trace
        header, trace_id, _ = _traceparent("split-dag", 0)
        body = json.dumps({"meta": {"tags": {"trace": 1}},
                           "data": {"ndarray": rng.integers(0, vocab, size=(1, seq)).tolist()}}).encode()
        status, raw, _ = await _bearer_post(gport, token, body, headers={"traceparent": header})
        if status != 200:
            raise AssertionError(f"13b traced request: HTTP {status} {raw[:200]!r}")
        arm = json.loads(raw)["meta"]["routing"]["eg"]
        engine_rec = json.loads(await _get(split.port, f"/traces/{trace_id}"))
        unit_rec = json.loads(await _get(ports[arm], f"/traces/{trace_id}"))
        row["trace"] = _split_trace(engine_rec, unit_rec, names[arm], trace_id)
        print(f"[{card}] 13b one request's hop to {names[arm]}: {json.dumps(row['trace'])}", flush=True)
        # planted: the arms' endpoints swapped
        swapped, _, _ = await _start(_remote_copy(ports[::-1], "swapped"))
        servers.append(swapped)
        sync_router(swapped.executor.root.children[0].unit, local_router)
        swap_pairs = []
        for _ in range(SPLIT_FAULT_REQUESTS):
            body = json.dumps({"data": {"ndarray": rng.integers(0, vocab, size=(1, seq)).tolist()}}).encode()
            _, _, s_raw, _ = await _request(swapped.port, body)
            _, _, l_raw, _ = await _request(local.port, body)
            swap_pairs.append((json.loads(s_raw), json.loads(l_raw)))
        must_fail("13b the arms' endpoints swapped", lambda: hold_split("13b swapped", swap_pairs))
        # a unit server answering 400 to malformed bodies: the breaker stays
        # closed; a client that counts the 4xx must open it
        breaker = ({"name": "breaker_failure_threshold", "value": str(MALFORMED), "type": "INT"},
                   {"name": "breaker_error_rate", "value": "1.0", "type": "FLOAT"})
        graph = {"name": names[0], "type": "MODEL", "parameters": list(breaker),
                 "endpoint": {"service_host": "127.0.0.1", "service_port": ports[0], "type": "REST"}}
        spec = SeldonDeployment.from_dict({"spec": {"name": "breaker", "predictors": [
            {"name": "p", "graph": graph}]}}).spec.predictors[0]
        ex = build_executor(spec)
        answers = await _malformed_answers(ex)
        breaker_check("13b", ex, names[0], answers)
        real = remote.RemoteUnit._status_error
        remote.RemoteUnit._status_error = staticmethod(
            lambda url, status, body: APIException(real(url, status, body).error, real(url, status, body).info))
        try:
            ex = build_executor(spec)
            planted = await _malformed_answers(ex)
        finally:
            remote.RemoteUnit._status_error = staticmethod(real)
        must_fail("13b a client counting 4xx against the breaker", lambda: breaker_check("13b planted", ex, names[0],
                                                                                          planted))
        print(f"[{card}] 13b {MALFORMED} answers of 400 from {names[0]}'s unit server left its breaker closed; "
              f"planted faults failed their checks (swapped endpoints, a client counting 4xx)", flush=True)
        # numbers: the split DAG (its engine's ingress) and the in-process DAG, in turns
        runs = {"split": [], "in_process": []}
        for turn in ("split", "in_process", "in_process", "split"):
            port = split.port if turn == "split" else local.port
            runs[turn].append(await _gate_points(card, f"13b {turn}", port, {"payload": "json", "features": seq}))
        row["load"] = _turns_summary(runs)
        keys = {}
        for s in (local, *twin_arms):
            for node in s.executor.root.walk():
                rt = getattr(node.unit, "runtime", None)
                if rt is not None:
                    keys[f"{s.deployment_name}/{node.name}"] = rt.recompiles_since_warmup()
        row["keys_after_warmup"] = keys
        if any(keys.values()):
            raise AssertionError(f"13b: new dispatch keys after warmup {keys}")
    finally:
        from seldon_core_tpu_torch.engine.remote import _RestSession

        # the engines' pooled connections first: a server's wait_closed
        # waits for its clients' kept-alive connections
        await _RestSession.close()
        if gws is not None:
            gws.close()
        for s in servers:
            await s.stop()
    return row


ROUTER_CLASS = """
class PickOne:
    def route(self, X, names):
        return 1
    def send_feedback(self, X, names, routing, reward, truth):
        self.saw = reward
"""


def _microservice_spawn():
    """The microservice CLI serving MnistCnn (train_steps 0 from
    PREDICTIVE_UNIT_PARAMETERS) on a port of its own, a spawn to await."""
    params = [{"name": "train_steps", "value": "0", "type": "INT"}]
    if DEVICE != "cuda":
        params.append({"name": "device", "value": DEVICE, "type": "STRING"})
    return _spawn(["seldon_core_tpu_torch.serving.microservice", "MnistCnn", "REST", "--service-type", "MODEL",
                   "--model-dir", MNIST_CNN_DIR, "--port", "0"], "microservice MnistCnn",
                  env={"PREDICTIVE_UNIT_PARAMETERS": json.dumps(params)})


async def container_contract(card, spawn) -> dict:
    """Phase 13c: the reference's container contract. The microservice CLI
    serving examples/models/torch_mnist_cnn (MnistCnn, train_steps 0 from
    PREDICTIVE_UNIT_PARAMETERS) in a process of its own on the card, driven
    by tools/contract.py with its contract.json (each batch answered 200,
    [CONTRACT_BATCH, 10] probabilities) and consumed by an engine's
    RemoteUnit (its answers bit for bit the class called in this process);
    then /route and /send-feedback on a router class."""
    import numpy as np

    from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.engine.remote import RemoteUnit
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.serving.microservice import load_user_object, serve_microservice
    from seldon_core_tpu_torch.tools import contract

    model_dir = MNIST_CNN_DIR
    _, port, boot_s = await spawn
    row = {"boot_s": round(boot_s, 3)}
    router = None
    try:
        spec = json.loads((ROOT / model_dir / "contract.json").read_text())
        t0 = time.perf_counter()
        outs = await asyncio.to_thread(contract.run, spec, "127.0.0.1", port, rounds=CONTRACT_ROUNDS,
                                       batch_size=CONTRACT_BATCH, seed=5)
        row["contract_s"] = round(time.perf_counter() - t0, 3)
        for out in outs:
            _check_probs(out, CONTRACT_BATCH, 10)
        graph = {"name": "mnist-cnn", "type": "MODEL",
                 "endpoint": {"service_host": "127.0.0.1", "service_port": port, "type": "REST"}}
        ex = build_executor(SeldonDeployment.from_dict({"spec": {"name": "c", "predictors": [
            {"name": "p", "graph": graph}]}}).spec.predictors[0])
        x = np.random.default_rng(6).random((CONTRACT_BATCH, 784), dtype=np.float32)
        out = await ex.execute(SeldonMessage.from_array(x))
        user = load_user_object("MnistCnn", model_dir, {"train_steps": 0, **({} if DEVICE == "cuda" else
                                                                             {"device": DEVICE})})
        want = np.asarray(user.predict(x, []), np.float32)
        got = np.asarray(out.array)
        row["remote_vs_in_process_max_abs"] = float(np.abs(got - want).max())
        if not np.array_equal(got, want):
            raise AssertionError(f"13c: the RemoteUnit's answers differ from the class in-process by "
                                 f"{row['remote_vs_in_process_max_abs']}")
        print(f"[{card}] 13c microservice MnistCnn (boot {boot_s:.3f} s): {CONTRACT_ROUNDS} contract batches of "
              f"{CONTRACT_BATCH} answered 200 with [{CONTRACT_BATCH}, 10] probabilities; a RemoteUnit's answers "
              f"bit for bit the class in-process", flush=True)
        SPLIT_DIR.mkdir(parents=True, exist_ok=True)
        (SPLIT_DIR / "PickOne.py").write_text(ROUTER_CLASS)
        user = load_user_object("PickOne", str(SPLIT_DIR))
        router, _, _ = await serve_microservice(user, "PickOne", "ROUTER", host="127.0.0.1", http_port=0)
        rport = router.sockets[0].getsockname()[1]
        status, _, raw, _ = await _request(rport, json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
                                           path="/route")
        if status != 200 or json.loads(raw)["data"]["tensor"] != {"shape": [1, 1], "values": [1.0]}:
            raise AssertionError(f"13c /route: HTTP {status} {raw[:200]!r}")
        fb = {"request": {"data": {"ndarray": [[1.0, 2.0]]}}, "response": {"meta": {"routing": {"PickOne": 1}}},
              "reward": 0.5}
        status, _, raw, _ = await _request(rport, json.dumps(fb).encode(), path="/send-feedback")
        if status != 200 or user.saw != 0.5:
            raise AssertionError(f"13c /send-feedback: HTTP {status}, the class saw {getattr(user, 'saw', None)}")
        unit = RemoteUnit(SeldonDeployment.from_dict({"spec": {"name": "r", "predictors": [{"name": "p", "graph": {
            "name": "PickOne", "type": "ROUTER", "children": [],
            "endpoint": {"service_host": "127.0.0.1", "service_port": rport, "type": "REST"}}}]}}).spec
            .predictors[0].graph)
        branch = await unit.route(SeldonMessage.from_array(np.ones((1, 2), np.float32)))
        await unit.send_feedback(Feedback(request=SeldonMessage.from_array(np.ones((1, 2), np.float32)), reward=0.25),
                                 branch)
        if branch != 1 or user.saw != 0.25:
            raise AssertionError(f"13c RemoteUnit on the router: branch {branch}, reward seen {user.saw}")
        print(f"[{card}] 13c router class: /route a 1x1 tensor [[1.0]], /send-feedback reached it, and a "
              f"RemoteUnit's route and feedback too", flush=True)
    finally:
        from seldon_core_tpu_torch.engine.remote import _RestSession

        await _RestSession.close()
        if router is not None:
            router.close()
    return row


async def serve_split_data_plane(card) -> dict:
    """Phase 13: 13a the gateway in front of an in-process engine, 13b the
    split DAG, 13c the container contract. Returns the phase's numbers and
    its flash launches (those counted on the in-process paths: a unit
    server in another process is not counted from here)."""
    from seldon_core_tpu_torch.engine.remote import _RestSession
    from seldon_core_tpu_torch.ops import int8_matmul
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    # the phase's three other processes boot at once, during 13a's checks
    names = [a["name"] for a in _dag_arms()]
    spawns = [asyncio.ensure_future(_spawn(
        ["seldon_core_tpu_torch.serving.server", "--deployment", str(_arm_deployment(a, a["name"])), "--warmup",
         "--host", "127.0.0.1", "--port", "0", "--grpc-port", "0", "--device", DEVICE], f"unit server {a['name']}"))
        for a in _dag_arms()]
    spawns.append(asyncio.ensure_future(_microservice_spawn()))

    async def boots():
        await asyncio.gather(*spawns, return_exceptions=True)

    int8_before = int8_matmul.LAUNCHES.count
    LAUNCHES.reset()  # the phase's paths run from here
    try:
        gate = await gateway_in_front(card, boots)
        split = await split_dag(card, spawns[:len(names)])
        container = await container_contract(card, spawns[-1])
    finally:
        await _RestSession.close()
        for task in spawns:
            if not task.done():
                task.cancel()
        for done in await asyncio.gather(*spawns, return_exceptions=True):
            if not isinstance(done, BaseException):
                await _reap(done[0])
    return {"gateway": gate, "split_dag": split, "container": container,
            "launches": {"flash_attention": LAUNCHES.count, "int8_matmul": int8_matmul.LAUNCHES.count - int8_before}}


# ---------------------------------------------------------------- phase 14
GRPC_REQUESTS = 20  # one-row id requests each way (gRPC ports, gateway modes), each also sent over REST
GRPC_LOAD_TURNS = ("grpc", "rest", "rest", "grpc")
GATEWAY_TURNS = ("aio", "sync", "web", "rest")
GRPC_CALL_S = 60.0  # one in-process gRPC call's limit


def grpc_libraries(card) -> dict:
    """The gRPC libraries as this host has them; a missing one, or copied
    ``_pb2`` modules that this protobuf cannot load, fail the phase."""
    import importlib

    versions = {}
    for name in ("grpc", "google.protobuf"):
        try:
            versions[name] = importlib.import_module(name).__version__
        except ImportError as e:
            raise AssertionError(f"phase 14 needs {name} on this host: {e}") from e
    from google.protobuf.internal import api_implementation

    versions["protobuf_implementation"] = api_implementation.Type()
    print(f"[{card}] 14 libraries: {json.dumps(versions)}", flush=True)
    try:
        from seldon_core_tpu_torch.proto import prediction_pb2, seldon_deployment_pb2  # noqa: F401
    except Exception as e:  # noqa: BLE001 - report the versions with the failure
        raise AssertionError(f"the copied _pb2 modules do not load under {versions}: {e!r}") from e
    return versions


def grpc_load_main(argv: list) -> int:
    """``chip_smoke.py --grpc-load SPEC``: closed-loop gRPC or gRPC-Web
    callers in this process, for one load point of phase 14 (the load
    generator speaks REST only). SPEC is JSON: target host:port,
    transport (grpc or web), method path, request bytes (hex), metadata
    pairs, users, seconds. Each user is a closed loop on its own channel
    (gRPC) or keep-alive connection (gRPC-Web), connected before the
    window. Prints one JSON line: completions in the window, errors (a
    transport failure or a FAILURE status in the answer) and every
    latency in ms."""
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb

    spec = json.loads(argv[0])
    body = bytes.fromhex(spec["body_hex"])
    metadata = tuple(tuple(kv) for kv in spec["metadata"])
    host, port = spec["target"].rsplit(":", 1)
    lat, errors, in_window = [], [0], [0]

    def failed(reply: bytes) -> bool:
        msg = pb.SeldonMessage.FromString(reply)
        return msg.HasField("status") and msg.status.status == pb.Status.FAILURE

    async def grpc_user(ready) -> None:
        import grpc

        async with grpc.aio.insecure_channel(spec["target"]) as ch:
            call = ch.unary_unary(spec["path"])
            await asyncio.wait_for(ch.channel_ready(), 30)
            stop_at = await ready()
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                try:
                    bad = failed(await call(body, metadata=metadata, timeout=30))
                except Exception:  # noqa: BLE001 - counted, the loop goes on
                    bad = True
                t1 = time.perf_counter()
                errors[0] += bad
                lat.append((t1 - t0) * 1e3)
                in_window[0] += t1 <= stop_at

    async def web_user(ready) -> None:
        extra = "".join(f"{k}: {v}\r\n" for k, v in metadata)
        req = (f"POST {spec['path']} HTTP/1.1\r\nHost: {host}\r\nContent-Type: application/grpc-web+proto\r\n"
               f"{extra}Content-Length: {len(body)}\r\n\r\n").encode() + body
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            stop_at = await ready()
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                writer.write(req)
                head = await reader.readuntil(b"\r\n\r\n")
                payload = await reader.readexactly(int(re.search(rb"(?i)content-length: *(\d+)", head).group(1)))
                t1 = time.perf_counter()
                n = int.from_bytes(payload[1:5], "big")
                errors[0] += (not head.startswith(b"HTTP/1.1 200") or payload[:1] != b"\x00"
                              or failed(payload[5:5 + n]) or b"grpc-status:0" not in payload[5 + n:])
                lat.append((t1 - t0) * 1e3)
                in_window[0] += t1 <= stop_at
        finally:
            writer.close()

    async def run() -> None:
        users = int(spec["users"])
        connected, count, window = asyncio.Event(), [0], {}

        async def ready() -> float:
            # the window opens once every user is connected; returns its end
            count[0] += 1
            if count[0] == users:
                window["stop"] = time.perf_counter() + float(spec["seconds"])
                connected.set()
            await connected.wait()
            return window["stop"]

        user = grpc_user if spec["transport"] == "grpc" else web_user
        await asyncio.gather(*(user(ready) for _ in range(users)))

    asyncio.run(run())
    print(json.dumps({"window_requests": in_window[0], "errors": errors[0], "latencies_ms": lat}), flush=True)
    return 0


def _percentile(xs: list, q: float) -> float:
    """The load generator's percentile (``tools/loadtest.py``)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))] if xs else 0.0


async def _grpc_load_point(transport: str, port: int, path: str, body: bytes, metadata: tuple, users: int) -> dict:
    """One closed-loop load point of gRPC (or gRPC-Web) callers, run as
    ``chip_smoke.py --grpc-load`` in LOAD_WORKERS other processes (one for
    a single user), as the REST load generator runs; the same summary keys
    as its."""
    workers = 1 if users == 1 else LOAD_WORKERS
    procs = []
    for w in range(workers):
        spec = {"target": f"127.0.0.1:{port}", "transport": transport, "path": path, "body_hex": body.hex(),
                "metadata": [list(kv) for kv in metadata], "users": users // workers + (w < users % workers),
                "seconds": LOAD_SECONDS}
        procs.append(await asyncio.create_subprocess_exec(
            sys.executable, str(ROOT / "chip_smoke.py"), "--grpc-load", json.dumps(spec),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE, cwd=str(ROOT)))
    outs = []
    try:
        for proc in procs:
            out, err = await asyncio.wait_for(proc.communicate(), timeout=120)
            if proc.returncode != 0:
                raise AssertionError(f"grpc load worker exited {proc.returncode}: {err.decode()[-500:]}")
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
    lat = [x for o in outs for x in o["latencies_ms"]]
    summary = {"requests": len(lat), "errors": sum(o["errors"] for o in outs),
               "requests_per_sec": round(sum(o["window_requests"] for o in outs) / LOAD_SECONDS, 2),
               "p50_ms": round(_percentile(lat, 50), 2), "p99_ms": round(_percentile(lat, 99), 2),
               "workers": workers}
    if summary["errors"] or not lat:
        raise AssertionError(f"{transport} load at {users} users: {summary}")
    return summary


def _grpc_answer(reply) -> "np.ndarray":
    """A SeldonMessage proto's tensor answer as float32 (values travel as
    float64, exactly the float32 widened)."""
    import numpy as np

    if reply.HasField("status") and reply.status.status == reply.status.FAILURE:
        raise AssertionError(f"a gRPC answer failed: {reply.status}")
    t = reply.data.tensor
    return np.asarray(t.values, dtype=np.float64).astype(np.float32).reshape(tuple(t.shape))


def _json_answer(out: dict) -> "np.ndarray":
    import numpy as np

    data = out["data"]
    if "tensor" in data:
        return np.asarray(data["tensor"]["values"], np.float64).astype(np.float32).reshape(data["tensor"]["shape"])
    return np.asarray(data["ndarray"], np.float64).astype(np.float32)


def _same_bits(label: str, a, b) -> None:
    import numpy as np

    if a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes():
        gap = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.shape == b.shape else None
        raise AssertionError(f"{label}: answers differ (shapes {a.shape} {b.shape}, max gap {gap})")


def _tensor_request(ids):
    """A one-row id request as the reference's tensor arm (ids below 2^24
    go through float32 and float64 exactly)."""
    import numpy as np

    from seldon_core_tpu_torch.core.codec_proto import message_to_proto
    from seldon_core_tpu_torch.core.message import SeldonMessage

    return message_to_proto(SeldonMessage.from_array(np.asarray(ids, np.float32)))


def _web_frames(body: bytes) -> list:
    frames, i = [], 0
    while i + 5 <= len(body):
        n = int.from_bytes(body[i + 1:i + 5], "big")
        frames.append((body[i], body[i + 5:i + 5 + n]))
        i += 5 + n
    return frames


async def _web_call(port: int, path: str, frame: bytes, token: str | None):
    """One gRPC-Web call through the gateway's fast ingress: (HTTP status,
    frames, wall ms)."""
    headers = {"oauth_token": token} if token else {}
    status, _, payload, ms = await _request(port, frame, "application/grpc-web+proto", path, headers=headers)
    return status, _web_frames(payload), ms


async def _web_predict(port: int, request_pb, token: str | None):
    """A gRPC-Web Seldon.Predict: the answer proto, grpc-status:0 checked."""
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.serving.wire import grpc_web_frame

    status, frames, ms = await _web_call(port, "/seldon.tpu.Seldon/Predict",
                                         grpc_web_frame(0, request_pb.SerializeToString()), token)
    if status != 200 or [f for f, _ in frames] != [0, 0x80] or b"grpc-status:0" not in frames[1][1]:
        raise AssertionError(f"gRPC-Web predict: HTTP {status}, frames {frames}")
    return pb.SeldonMessage.FromString(frames[0][1]), ms


def _refusal(label: str, reply) -> None:
    """The gateway's refusal: a FAILURE SeldonMessage with
    APIFE_GRPC_NO_PRINCIPAL_FOUND (205)."""
    if not (reply.HasField("status") and reply.status.code == 205 and reply.status.status == reply.status.FAILURE):
        raise AssertionError(f"{label}: answered {reply.status if reply.HasField('status') else 'data'}, want a "
                             f"failure with code 205")


async def grpc_predictor(card, server) -> tuple:
    """Phase 14a: bert_base_flash's own gRPC port beside its REST ingress.
    GRPC_REQUESTS one-row id requests by seldon.tpu.Seldon/Predict as
    tensor, each answer bit for bit the REST ingress's for the same ids, 12
    flash launches each; the same request under seldon.protos and by
    Model/Predict; Admin.ServerInfo; one npy binData request answered in
    binData; then 1-user p50/p99 and 16-user predictions/s of gRPC callers
    against the REST load generator, in turns. Returns the row and the
    ids and REST answers (14b holds the gateway to them)."""
    import grpc
    import numpy as np
    import torch

    from seldon_core_tpu_torch.core.codec_npy import array_from_npy, npy_from_array
    from seldon_core_tpu_torch.core.message import SeldonMessage
    from seldon_core_tpu_torch.core.codec_proto import message_to_proto
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub

    runtime = _model_runtime(server)
    seq, vocab, layers = runtime.feature_shape[0], runtime.params["tok_emb"].shape[0], len(runtime.params["layers"])
    rng = np.random.default_rng(14)
    ids_list = [rng.integers(0, vocab, size=(1, seq)) for _ in range(GRPC_REQUESTS)]
    row: dict = {}
    rest_answers, deltas, ms = [], [], {"grpc": [], "rest": []}
    async with grpc.aio.insecure_channel(f"127.0.0.1:{server.grpc_port}") as ch:
        stub = ServiceStub(ch, "Seldon")
        for i, ids in enumerate(ids_list):
            before = LAUNCHES.count
            t0 = time.perf_counter()
            reply = await stub.Predict(_tensor_request(ids), timeout=GRPC_CALL_S)
            ms["grpc"].append((time.perf_counter() - t0) * 1e3)
            deltas.append(LAUNCHES.count - before)
            body = json.dumps({"data": {"tensor": {"shape": [1, seq], "values": ids.reshape(-1).tolist()}}}).encode()
            status, _, raw, rest_ms = await _request(server.port, body)
            ms["rest"].append(rest_ms)
            if status != 200:
                raise AssertionError(f"14a request {i}: REST HTTP {status} {raw[:200]!r}")
            rest = _json_answer(json.loads(raw))
            got = _grpc_answer(reply)
            _check_probs(got.tolist(), 1)
            _same_bits(f"14a request {i}: gRPC against REST", got, rest)
            rest_answers.append(rest)
        require_launches("14a bert_base_flash over gRPC flash_attention", deltas, layers)
        req = _tensor_request(ids_list[0])
        for pkg, service in (("seldon.protos", "Seldon"), ("seldon.tpu", "Model"), ("seldon.protos", "Model")):
            reply = await getattr(ServiceStub(ch, service, package=pkg), "Predict")(req, timeout=GRPC_CALL_S)
            _same_bits(f"14a /{pkg}.{service}/Predict", _grpc_answer(reply), rest_answers[0])
        info = await ServiceStub(ch, "Admin").ServerInfo(pb.ServerInfoRequest(), timeout=GRPC_CALL_S)
        want = ("gpu", torch.cuda.device_count()) if DEVICE == "cuda" else ("cpu", 1)
        if (info.platform, info.device_count, info.deployment_name) != (*want, server.deployment_name):
            raise AssertionError(f"14a ServerInfo: {info}, want platform/count {want}")
        reply = await stub.Predict(message_to_proto(SeldonMessage(bin_data=npy_from_array(
            ids_list[1].astype(np.float32)))), timeout=GRPC_CALL_S)
        if reply.WhichOneof("data_oneof") != "binData":
            raise AssertionError(f"14a npy binData request answered in {reply.WhichOneof('data_oneof')}")
        _same_bits("14a npy binData against REST", array_from_npy(reply.binData).astype(np.float32), rest_answers[1])
    print(f"[{card}] 14a {GRPC_REQUESTS} gRPC answers bit for bit the REST ingress's, {layers} flash launches each "
          f"({sum(deltas)}); seldon.protos and Model/Predict the same; ServerInfo {info.platform} x"
          f"{info.device_count}; npy binData answered in binData; one-request wall ms gRPC "
          f"{round(sum(ms['grpc']) / len(ms['grpc']), 4)} REST {round(sum(ms['rest']) / len(ms['rest']), 4)}",
          flush=True)
    row["launches"] = sum(deltas)
    row["server_info"] = {"platform": info.platform, "device_count": info.device_count}
    body = req.SerializeToString()
    runs = {"grpc": [], "rest": []}
    for turn in GRPC_LOAD_TURNS:
        points = {}
        for users in SPLIT_LOAD:
            if turn == "grpc":
                p = await _grpc_load_point("grpc", server.grpc_port, "/seldon.tpu.Seldon/Predict", body, (), users)
            else:
                p = await _load_point(server.port, users, {"payload": "json", "features": seq})
            print(f"[{card}] load 14a {turn} users={users} {json.dumps(p)}", flush=True)
            points[users] = p
        runs[turn].append(points)
    row["load"] = _turns_summary(runs)
    return row, ids_list, rest_answers


async def grpc_gateway_paths(card, server, gw, ids_list: list, rest_answers: list) -> dict:
    """Phase 14b: the same bert_base_flash behind the gateway over gRPC, in
    aio mode and in sync mode, and over gRPC-Web on the gateway's fast
    ingress: GRPC_REQUESTS requests each way with oauth_token (metadata, or
    the header), each answer bit for bit the REST ingress's (14a's), 12
    flash launches each and GRPC_REQUESTS audit records each way; a missing
    and a revoked token refused with APIFE_GRPC_NO_PRINCIPAL_FOUND each
    way (inside a grpc-status:0 frame over gRPC-Web), a malformed gRPC-Web
    frame grpc-status:3, and a gateway planted to accept a missing token
    failing the refusal check; 1-user p50/p99 of each way against the REST
    gateway, in turns."""
    import grpc

    from seldon_core_tpu_torch.gateway import grpc_gateway
    from seldon_core_tpu_torch.gateway.grpc_gateway import OAUTH_METADATA_KEY, start_gateway_grpc
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.proto.services import ServiceStub
    from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server

    runtime = _model_runtime(server)
    seq, layers = runtime.feature_shape[0], len(runtime.params["layers"])
    token = gw.oauth.issue_token(GATE_KEY, GATE_SECRET)["access_token"]
    aio = await start_gateway_grpc(gw, "127.0.0.1", 0, mode="aio")
    sync = await start_gateway_grpc(gw, "127.0.0.1", 0, mode="sync")
    web = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    wport = web.sockets[0].getsockname()[1]
    ports = {"aio": aio.bound_port, "sync": sync.bound_port}
    channels = {mode: grpc.aio.insecure_channel(f"127.0.0.1:{p}") for mode, p in ports.items()}
    stubs = {mode: ServiceStub(ch, "Seldon") for mode, ch in channels.items()}
    row: dict = {"ports": {**ports, "web": wport}}

    async def predict(mode: str, request_pb, tok: str | None):
        if mode == "web":
            reply, _ = await _web_predict(wport, request_pb, tok)
            return reply
        md = ((OAUTH_METADATA_KEY, tok),) if tok else ()
        return await stubs[mode].Predict(request_pb, metadata=md, timeout=GRPC_CALL_S)

    try:
        deltas = []
        for mode in ("aio", "sync", "web"):
            before_audit = len(gw.audit.topics.get(GATE_KEY, ()))
            for i, (ids, want) in enumerate(zip(ids_list, rest_answers)):
                before = LAUNCHES.count
                reply = await predict(mode, _tensor_request(ids), token)
                deltas.append(LAUNCHES.count - before)
                _same_bits(f"14b {mode} request {i}: the gateway against REST", _grpc_answer(reply), want)
            audit = gw.audit.topics.get(GATE_KEY, ())
            if len(audit) - before_audit != GRPC_REQUESTS:
                raise AssertionError(f"14b {mode}: {len(audit) - before_audit} audit records, want {GRPC_REQUESTS}")
            last = audit[-1]
            if _json_answer(last["response"]).tobytes() != rest_answers[-1].tobytes():
                raise AssertionError(f"14b {mode}: the last audit record is not the last answer")
        require_launches("14b bert_base_flash behind the gateway (aio, sync, gRPC-Web) flash_attention", deltas,
                         layers)
        print(f"[{card}] 14b {GRPC_REQUESTS} requests each through the gRPC gateway (aio, sync) and gRPC-Web, bit "
              f"for bit the REST ingress's; {layers} launches each ({sum(deltas)}); {GRPC_REQUESTS} audit records "
              f"each way", flush=True)
        row["launches"] = sum(deltas)
        # numbers: 1-user p50/p99 each way against the REST gateway, in turns
        body = _tensor_request(ids_list[0]).SerializeToString()
        runs = {m: [] for m in ("aio", "sync", "web", "rest")}
        for turn in GATEWAY_TURNS:
            if turn == "rest":
                p = await _load_point(wport, 1, {"payload": "json", "features": seq, "oauth": (GATE_KEY, GATE_SECRET)})
            elif turn == "web":
                from seldon_core_tpu_torch.serving.wire import grpc_web_frame

                p = await _grpc_load_point("web", wport, "/seldon.tpu.Seldon/Predict", grpc_web_frame(0, body),
                                           ((OAUTH_METADATA_KEY, token),), 1)
            else:
                p = await _grpc_load_point("grpc", ports[turn], "/seldon.tpu.Seldon/Predict", body,
                                           ((OAUTH_METADATA_KEY, token),), 1)
            print(f"[{card}] load 14b {turn} users=1 {json.dumps(p)}", flush=True)
            runs[turn].append(p)
        row["load_users_1"] = {m: {"p50_ms": [r["p50_ms"] for r in rs], "p99_ms": [r["p99_ms"] for r in rs]}
                               for m, rs in runs.items()}

        # the refusals
        req = _tensor_request(ids_list[0])

        async def no_token_refused(label: str) -> None:
            for mode in ("aio", "sync", "web"):
                _refusal(f"{label} {mode}: a missing token", await predict(mode, req, None))

        await no_token_refused("14b")
        from seldon_core_tpu_torch.graph.spec import DeploymentSpec

        dep = gw.store.by_principal(GATE_KEY)
        gw.store.deployment_added(DeploymentSpec(name=dep.name, oauth_key=GATE_KEY + "-2", oauth_secret=GATE_SECRET,
                                                 predictors=dep.predictors))
        try:
            for mode in ("aio", "sync", "web"):
                _refusal(f"14b {mode}: a revoked token", await predict(mode, req, token))
        finally:
            gw.store.deployment_added(dep)
        status, frames, _ = await _web_call(wport, "/seldon.tpu.Seldon/Predict", b"\x00\x00\x00", token)
        if status != 200 or len(frames) != 1 or frames[0][0] != 0x80 or b"grpc-status:3" not in frames[0][1]:
            raise AssertionError(f"14b a malformed gRPC-Web frame: HTTP {status}, frames {frames}")
        # planted: a gateway that takes a missing oauth_token as a valid one
        real = grpc_gateway.metadata_value
        good = gw.oauth.issue_token(GATE_KEY, GATE_SECRET)["access_token"]
        grpc_gateway.metadata_value = lambda md, key: real(md, key) or (good if key == OAUTH_METADATA_KEY else None)
        try:
            await must_fail_async("14b a gRPC gateway that accepts a missing oauth_token",
                                  lambda: no_token_refused("14b planted"))
        finally:
            grpc_gateway.metadata_value = real
        print(f"[{card}] 14b a missing and a revoked token refused with code 205 each way (gRPC-Web inside "
              f"grpc-status:0), a malformed gRPC-Web frame grpc-status:3; a gateway accepting a missing token "
              f"failed the check", flush=True)
    finally:
        for ch in channels.values():
            await ch.close()
        await aio.stop(None)
        await sync.stop(None)
        web.close()
        await web.wait_closed()
    return row


async def grpc_split_dag(card, arms_spawned: list, restart) -> dict:
    """Phase 14c: full_dag_bert split over gRPC. Both BERT-base arms are
    unit-server processes serving REST and gRPC (booted at the phase's
    start); the engine of a copy of full_dag_bert_remote.json whose arms'
    endpoints are ``type: GRPC`` serves behind the gateway's gRPC ingress
    (aio) with full_dag_bert's OAuth client; a REST split engine over the
    same processes and the in-process full_dag_bert beside it.
    SPLIT_REQUESTS one-row requests to the three, in turns: routes and
    probabilities equal request by request; a feedback by gRPC moving only
    the routed arm's reward; one request's engine unit span against the
    unit server's ingress span that continues the gRPC metadata's
    traceparent. Planted: a codec that drops meta.routing on encode must
    fail the route check. Then one arm's process is killed: a request to it
    fails at the transport, drops the cached channel and counts in the
    breaker (a RemoteUnit whose transport check never matches must fail
    the channel check); ``restart`` boots it again on the same gRPC port.
    Returns the row and ``recover``, to await once other work has covered
    the boot: the same engine then serves the next request."""
    import grpc
    import numpy as np

    from seldon_core_tpu_torch.core import codec_proto
    from seldon_core_tpu_torch.core.errors import APIException
    from seldon_core_tpu_torch.core.message import SeldonMessage
    from seldon_core_tpu_torch.engine import remote
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.gateway.grpc_gateway import OAUTH_METADATA_KEY, start_gateway_grpc
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import ServiceStub
    from seldon_core_tpu_torch.serving.server import load_predictor
    from seldon_core_tpu_torch.tools.stack import build_gateway_stack

    names = [a["name"] for a in _dag_arms()]
    servers, gateways, channels = [], [], []
    row: dict = {}
    try:
        local, _, _ = await _start(BASELINE_DIR / "full_dag_bert.json")
        servers.append(local)
        done = [await task for task in arms_spawned]
        procs = [d[0] for d in done]
        rest_ports, grpc_ports = [d[1] for d in done], [d[0].grpc_port for d in done]
        row["unit_server_boot_s"] = [round(d[2], 3) for d in done]
        print(f"[{card}] 14c unit servers {names} serving REST {rest_ports} and gRPC {grpc_ports}, boot s "
              f"{row['unit_server_boot_s']} (booted during 14a and 14b)", flush=True)
        rest_split, _, _ = await _start(_remote_copy(rest_ports, "rest14"))
        servers.append(rest_split)
        predictor, dep_name = load_predictor(str(_remote_copy(grpc_ports, "grpc", etype="GRPC")))
        dag = json.loads((BASELINE_DIR / "full_dag_bert.json").read_text())["spec"]
        split, gw, _, _ = build_gateway_stack(predictor, deployment_name=dep_name, oauth_key=dag["oauth_key"],
                                              oauth_secret=dag["oauth_secret"], device=DEVICE)
        await split.start("127.0.0.1", 0)
        servers.append(split)
        if [type(c.unit).__name__ for c in split.executor.root.children[0].children] != ["RemoteUnit"] * 2 or \
                not all(c.unit.is_grpc for c in split.executor.root.children[0].children):
            raise AssertionError("14c: the gRPC split engine's arms are not gRPC remote units")
        gate = await start_gateway_grpc(gw, "127.0.0.1", 0, mode="aio")
        gateways.append(gate)
        token = gw.oauth.issue_token(dag["oauth_key"], dag["oauth_secret"])["access_token"]
        md = ((OAUTH_METADATA_KEY, token),)
        ch = grpc.aio.insecure_channel(f"127.0.0.1:{gate.bound_port}")
        channels.append(ch)
        stub = ServiceStub(ch, "Seldon")
        runtime = local.executor.root.children[0].children[0].unit.runtime
        seq, vocab = runtime.feature_shape[0], runtime.params["tok_emb"].shape[0]
        rng = np.random.default_rng(141)

        layers = len(runtime.params["layers"])
        deltas = []

        async def three(ids, via_stub):
            """One request to the gRPC split, the REST split and the
            in-process DAG; the in-process one's launches are counted (the
            arms of the others run in other processes)."""
            before = LAUNCHES.count
            reply = await via_stub.Predict(_tensor_request(ids), metadata=md, timeout=GRPC_CALL_S)
            body = json.dumps({"data": {"ndarray": ids.tolist()}}).encode()
            r_status, _, r_raw, _ = await _request(rest_split.port, body)
            l_status, _, l_raw, _ = await _request(local.port, body)
            deltas.append(LAUNCHES.count - before)
            if (r_status, l_status) != (200, 200):
                raise AssertionError(f"14c: REST split HTTP {r_status}, in-process HTTP {l_status}")
            return reply, json.loads(r_raw), json.loads(l_raw)

        def hold_routes(label: str, triples: list) -> None:
            for i, (g, r, l) in enumerate(triples):
                routes = (dict(g.meta.routing), r["meta"].get("routing"), l["meta"].get("routing"))
                if not routes[0] or routes[0] != routes[1] or routes[1] != routes[2]:
                    raise AssertionError(f"{label} request {i}: routed gRPC {routes[0]}, REST {routes[1]}, "
                                         f"in-process {routes[2]}")
                _same_bits(f"{label} request {i}: gRPC split against in-process", _grpc_answer(g), _json_answer(l))
                _same_bits(f"{label} request {i}: REST split against in-process", _json_answer(r), _json_answer(l))

        triples = [await three(rng.integers(0, vocab, size=(1, seq)), stub) for _ in range(SPLIT_REQUESTS)]
        hold_routes("14c", triples)
        require_launches("14c in-process full_dag_bert flash_attention", deltas, layers)
        routes = [t[0].meta.routing["eg"] for t in triples]
        row["routes"] = routes
        row["launches"] = sum(deltas)
        print(f"[{card}] 14c {SPLIT_REQUESTS} requests: routes {routes} equal request by request across the gRPC "
              f"split (behind the gRPC gateway), the REST split and the in-process DAG; probabilities bit for bit",
              flush=True)
        # a feedback by gRPC through the gateway moves only the routed arm's reward
        router = split.executor.root.children[0].unit
        route = routes[-1]
        counts, rewards = list(router.counts), list(router.rewards)
        fb = pb.Feedback(response=triples[-1][0], reward=1.0)
        ack = await stub.SendFeedback(fb, metadata=md, timeout=GRPC_CALL_S)
        want_counts = [c + (i == route) for i, c in enumerate(counts)]
        want_rewards = [r + (1.0 if i == route else 0.0) for i, r in enumerate(rewards)]
        if (ack.HasField("status") and ack.status.status == ack.status.FAILURE) or router.counts != want_counts \
                or router.rewards != want_rewards:
            raise AssertionError(f"14c feedback: {ack.status}, router {router.counts} {router.rewards}, want "
                                 f"{want_counts} {want_rewards}")
        # one request's hop, from its trace (the traceparent rides gRPC metadata)
        header, trace_id, _ = _traceparent("grpc-split", 0)
        req = _tensor_request(rng.integers(0, vocab, size=(1, seq)))
        req.meta.tags["trace"].number_value = 1
        reply = await stub.Predict(req, metadata=md + (("traceparent", header),), timeout=GRPC_CALL_S)
        arm = reply.meta.routing["eg"]
        engine_rec = json.loads(await _get(split.port, f"/traces/{trace_id}"))
        unit_rec = json.loads(await _get(rest_ports[arm], f"/traces/{trace_id}"))
        row["trace"] = _split_trace(engine_rec, unit_rec, names[arm], trace_id, "14c")
        print(f"[{card}] 14c one request's gRPC hop to {names[arm]}: {json.dumps(row['trace'])}", flush=True)
        # planted: a codec that drops meta.routing on encode, the three
        # routers given the in-process one's state first
        local_router = local.executor.root.children[0].unit
        sync_router(router, local_router)
        sync_router(rest_split.executor.root.children[0].unit, local_router)
        real_encode = codec_proto.message_to_proto

        def drop_routing(msg):
            m = real_encode(msg)
            m.meta.ClearField("routing")
            return m

        codec_proto.message_to_proto = drop_routing
        try:
            planted_gate = await start_gateway_grpc(gw, "127.0.0.1", 0, mode="aio")
        finally:
            codec_proto.message_to_proto = real_encode
        gateways.append(planted_gate)
        pch = grpc.aio.insecure_channel(f"127.0.0.1:{planted_gate.bound_port}")
        channels.append(pch)
        planted = [await three(rng.integers(0, vocab, size=(1, seq)), ServiceStub(pch, "Seldon"))
                   for _ in range(SPLIT_FAULT_REQUESTS)]
        must_fail("14c a codec that drops meta.routing on encode", lambda: hold_routes("14c planted", planted))
        print(f"[{card}] 14c a feedback by gRPC moved only arm {route}'s reward; a codec that drops meta.routing "
              f"on encode failed the route check", flush=True)
        # one arm's process killed: a transport failure drops the cached
        # channel and counts in the breaker; restarted, the same engine serves
        breaker = ({"name": "breaker_failure_threshold", "value": "5", "type": "INT"},
                   {"name": "breaker_error_rate", "value": "1.0", "type": "FLOAT"})
        spec = SeldonDeployment.from_dict({"spec": {"name": "recover", "predictors": [{"name": "p", "graph": {
            "name": names[0], "type": "MODEL", "parameters": list(breaker),
            "endpoint": {"service_host": "127.0.0.1", "service_port": grpc_ports[0], "type": "GRPC"}}}]}}) \
            .spec.predictors[0]
        ex = build_executor(spec)
        ids = rng.integers(0, vocab, size=(1, seq)).astype(np.float32)
        before_kill = np.asarray((await ex.execute(SeldonMessage.from_array(ids))).array)
        await _reap(procs[0])

        async def transport_failure(label: str, executor) -> None:
            unit = executor.root.unit
            try:
                await executor.execute(SeldonMessage.from_array(ids))
            except APIException as e:
                info = e.info
            else:
                raise AssertionError(f"{label}: a request to a killed unit server was answered")
            if unit._grpc_channel is not None or unit._stub_cache:
                raise AssertionError(f"{label}: the failed call kept its cached channel ({info})")
            if executor.breaker_for(names[0])._consecutive_failures < 1:
                raise AssertionError(f"{label}: the breaker did not count the failure")

        await transport_failure("14c a killed arm", ex)
        real_check = remote.RemoteUnit._is_transport_failure
        remote.RemoteUnit._is_transport_failure = staticmethod(lambda e: False)
        try:
            await must_fail_async("14c a RemoteUnit whose transport check never matches",
                                  lambda: transport_failure("14c planted", build_executor(spec)))
        finally:
            remote.RemoteUnit._is_transport_failure = staticmethod(real_check)
        print(f"[{card}] 14c {names[0]}'s process killed: the request failed at the transport, dropped the cached "
              f"channel, counted in the breaker; a RemoteUnit whose transport check never matches failed the "
              f"check; restarting it on gRPC port {grpc_ports[0]}", flush=True)
        restarting = asyncio.ensure_future(restart(grpc_ports[0]))

        async def recover() -> dict:
            """Once the restarted arm serves: the same engine's next request."""
            _, _, boot_s = await restarting
            after = np.asarray((await ex.execute(SeldonMessage.from_array(ids))).array)
            _same_bits("14c the restarted arm through the same engine", after.astype(np.float32),
                       before_kill.astype(np.float32))
            if ex.root.unit._grpc_channel is None:
                raise AssertionError("14c: the recovered unit holds no channel")
            await remote.close_remote_units(ex)
            print(f"[{card}] 14c restarted in {boot_s:.3f} s: the same engine's next request served, bit for bit "
                  f"its answer before the kill", flush=True)
            return {"restart_boot_s": round(boot_s, 3)}

        keys = {}
        for node in local.executor.root.walk():
            rt = getattr(node.unit, "runtime", None)
            if rt is not None:
                keys[f"full_dag_bert/{node.name}"] = rt.recompiles_since_warmup()
        row["keys_after_warmup"] = keys
        if any(keys.values()):
            raise AssertionError(f"14c: new dispatch keys after warmup {keys}")
    finally:
        from seldon_core_tpu_torch.engine.remote import _RestSession

        await _RestSession.close()
        for c in channels:
            await c.close()
        for g in gateways:
            await g.stop(None)
        for s in servers:
            await s.stop()
    return row, recover


async def grpc_container(card, spawn) -> dict:
    """Phase 14d: the container contract over gRPC. The microservice CLI
    serving examples/models/torch_mnist_cnn in GRPC mode in a process of
    its own (no REST port), driven by tools/contract.py with ``use_grpc``
    (``--grpc``) and consumed by a GRPC RemoteUnit (bit for bit the class
    in this process); then Router.Route and Router.SendFeedback on a
    router class served GRPC-only in this process."""
    import grpc
    import numpy as np

    from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.engine.remote import RemoteUnit, close_remote_units
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.proto.services import ServiceStub
    from seldon_core_tpu_torch.serving.microservice import load_user_object, serve_microservice
    from seldon_core_tpu_torch.tools import contract

    proc, rest_port, boot_s = await spawn
    port = proc.grpc_port
    if rest_port is not None or port is None:
        raise AssertionError(f"14d: the GRPC microservice serves REST {rest_port}, gRPC {port}")
    row = {"boot_s": round(boot_s, 3)}
    router = None
    try:
        spec = json.loads((ROOT / MNIST_CNN_DIR / "contract.json").read_text())
        outs = await asyncio.to_thread(contract.run, spec, "127.0.0.1", port, rounds=CONTRACT_ROUNDS,
                                       batch_size=CONTRACT_BATCH, seed=5, use_grpc=True)
        for out in outs:
            _check_probs(out, CONTRACT_BATCH, 10)
        graph = {"name": "mnist-cnn", "type": "MODEL",
                 "endpoint": {"service_host": "127.0.0.1", "service_port": port, "type": "GRPC"}}
        ex = build_executor(SeldonDeployment.from_dict({"spec": {"name": "c", "predictors": [
            {"name": "p", "graph": graph}]}}).spec.predictors[0])
        x = np.random.default_rng(6).random((CONTRACT_BATCH, 784), dtype=np.float32)
        got = np.asarray((await ex.execute(SeldonMessage.from_array(x))).array).astype(np.float32)
        await close_remote_units(ex)
        user = load_user_object("MnistCnn", MNIST_CNN_DIR, {"train_steps": 0, **({} if DEVICE == "cuda" else
                                                                                 {"device": DEVICE})})
        _same_bits("14d a GRPC RemoteUnit against the class in-process", got,
                   np.asarray(user.predict(x, []), np.float32))
        print(f"[{card}] 14d microservice MnistCnn GRPC (boot {boot_s:.3f} s, no REST port): {CONTRACT_ROUNDS} "
              f"contract batches of {CONTRACT_BATCH} by tools/contract.py --grpc answered [{CONTRACT_BATCH}, 10] "
              f"probabilities; a GRPC RemoteUnit's answers bit for bit the class in-process", flush=True)
        SPLIT_DIR.mkdir(parents=True, exist_ok=True)
        (SPLIT_DIR / "PickOne.py").write_text(ROUTER_CLASS)
        user = load_user_object("PickOne", str(SPLIT_DIR))
        router = await serve_microservice(user, "PickOne", "ROUTER", host="127.0.0.1", enable_rest=False,
                                          grpc_port=0)
        rport = router.grpc_server.bound_port
        async with grpc.aio.insecure_channel(f"127.0.0.1:{rport}") as ch:
            reply = await ServiceStub(ch, "Router", package="seldon.protos").Route(
                _tensor_request([[1.0, 2.0]]), timeout=GRPC_CALL_S)
        if list(reply.data.tensor.shape) != [1, 1] or list(reply.data.tensor.values) != [1.0]:
            raise AssertionError(f"14d Router.Route answered {reply}")
        unit = RemoteUnit(SeldonDeployment.from_dict({"spec": {"name": "r", "predictors": [{"name": "p", "graph": {
            "name": "PickOne", "type": "ROUTER", "children": [],
            "endpoint": {"service_host": "127.0.0.1", "service_port": rport, "type": "GRPC"}}}]}}).spec
            .predictors[0].graph)
        branch = await unit.route(SeldonMessage.from_array(np.ones((1, 2), np.float32)))
        await unit.send_feedback(Feedback(request=SeldonMessage.from_array(np.ones((1, 2), np.float32)), reward=0.25),
                                 branch)
        await unit.close()
        if branch != 1 or user.saw != 0.25:
            raise AssertionError(f"14d GRPC RemoteUnit on the router: branch {branch}, reward seen "
                                 f"{getattr(user, 'saw', None)}")
        print(f"[{card}] 14d router class over gRPC: Router.Route a 1x1 tensor [[1.0]], Router.SendFeedback reached "
              f"it through a GRPC RemoteUnit", flush=True)
    finally:
        if router is not None:
            await router.grpc_server.stop(None)
    return row


def _free_port() -> int:
    """A port free at this moment (the server CLI's --grpc-port 0 turns
    gRPC off, so a unit server's gRPC port is chosen here)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grpc_unit_server(path: Path, label: str, grpc_port: int | None = None):
    """A unit server process (the server CLI, --warmup) serving REST on a
    free port and gRPC on ``grpc_port`` (a free one by default), a spawn to
    await."""
    return _spawn(["seldon_core_tpu_torch.serving.server", "--deployment", str(path), "--warmup", "--host",
                   "127.0.0.1", "--port", "0", "--grpc-port", str(grpc_port or _free_port()), "--device", DEVICE],
                  label)


async def serve_grpc(card) -> dict:
    """Phase 14: 14a the predictor's gRPC port, 14b the gateway over gRPC
    and gRPC-Web, 14c the split DAG over gRPC, 14d the container contract
    over gRPC. The two arm unit servers and the microservice boot as
    processes of their own at the start, during 14a and 14b (phase 13's
    processes are not shared: they end with its event loop). Returns the
    phase's numbers and its launches (those of this process's paths)."""
    from seldon_core_tpu_torch.gateway import MemoryAuditSink
    from seldon_core_tpu_torch.ops import int8_matmul
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.server import load_predictor
    from seldon_core_tpu_torch.tools.stack import build_gateway_stack

    libraries = grpc_libraries(card)
    arms = _dag_arms()
    paths = {a["name"]: _arm_deployment(a, a["name"]) for a in arms}
    spawns = [asyncio.ensure_future(_grpc_unit_server(paths[a["name"]], f"unit server {a['name']}")) for a in arms]
    params = [{"name": "train_steps", "value": "0", "type": "INT"}]
    if DEVICE != "cuda":
        params.append({"name": "device", "value": DEVICE, "type": "STRING"})
    spawns.append(asyncio.ensure_future(_spawn(
        ["seldon_core_tpu_torch.serving.microservice", "MnistCnn", "GRPC", "--service-type", "MODEL",
         "--model-dir", MNIST_CNN_DIR, "--grpc-port", "0"], "microservice MnistCnn GRPC",
        env={"PREDICTIVE_UNIT_PARAMETERS": json.dumps(params)})))
    restarted = []

    async def restart(grpc_port: int):
        name = arms[0]["name"]
        task = asyncio.ensure_future(_grpc_unit_server(paths[name], f"unit server {name} restarted", grpc_port))
        restarted.append(task)
        return await task

    int8_before = int8_matmul.LAUNCHES.count
    LAUNCHES.reset()  # the phase's paths run from here
    server = None
    try:
        predictor, name = load_predictor(str(BASELINE_DIR / "bert_base_flash.json"))
        t0 = time.perf_counter()
        server, gw, _, _ = build_gateway_stack(predictor, deployment_name=name, oauth_key=GATE_KEY,
                                               oauth_secret=GATE_SECRET, audit=MemoryAuditSink(), device=DEVICE)
        boot_s = time.perf_counter() - t0
        await server.start("127.0.0.1", 0, grpc_port=0)
        predictor_row, ids_list, rest_answers = await grpc_predictor(card, server)
        predictor_row["boot_s"] = round(boot_s, 3)
        gateway_row = await grpc_gateway_paths(card, server, gw, ids_list, rest_answers)
        keys = _model_runtime(server).recompiles_since_warmup()
        if keys:
            raise AssertionError(f"14a/14b: {keys} new dispatch keys after warmup")
        gateway_row["keys_after_warmup"] = keys
        await server.stop()
        server = None
        split_row, recover = await grpc_split_dag(card, spawns[:len(arms)], restart)
        container_row = await grpc_container(card, spawns[-1])  # while the killed arm boots again
        split_row.update(await recover())
    finally:
        if server is not None:
            await server.stop()
        for task in (*spawns, *restarted):
            if not task.done():
                task.cancel()
        for done in await asyncio.gather(*spawns, *restarted, return_exceptions=True):
            if not isinstance(done, BaseException):
                await _reap(done[0])
    return {"libraries": libraries, "predictor": predictor_row, "gateway": gateway_row, "split_dag": split_row,
            "container": container_row,
            "launches": {"flash_attention": LAUNCHES.count, "int8_matmul": int8_matmul.LAUNCHES.count - int8_before}}


# ---------------------------------------------------------------- phase 15
PLATFORM_DIR = ROOT / "build" / "platform"  # git-ignored: the watched CRs, the state store, the trace, per run
PLATFORM_REQUESTS = 4  # one-row requests per deployment, each also sent to a standalone server
PLATFORM_USERS = 16  # users on bert-base-flash while it is re-applied
PLATFORM_SIBLINGS = 4  # users on iris meanwhile, whose latency the apply must not move far
PLATFORM_QUIET_S = 1.0  # the window without an apply that the sibling latency is held against
PLATFORM_AFTER = 32  # answers begun after apply returned, at least
PLATFORM_WATCH_S = 0.2  # the directory watcher's interval
PLATFORM_WAIT_S = 60.0  # the longest a watched change may take to reconcile
PLATFORM_LOAD_TURNS = ("c", "python", "python", "c")
# Memory is read as memory_allocated() less cuBLAS's workspaces (active
# blocks of exactly CUBLAS_WORKSPACE_BYTES): torch keeps one per (handle,
# stream) for the process, and a capture on a thread or stream first seen
# in the phase makes one. Their count is bounded instead: at most
# PLATFORM_NEW_WORKSPACES new ones over the phase, none over 15c's
# apply-and-delete cycles (the phase's warmups run on one thread, and
# collected caches hand their capture streams on; planted, a new stream
# per cache takes one a cycle). Against that reading, a swap's or a
# delete's result may differ from the bytes the resident parameters
# account for by PLATFORM_SLACK_BYTES: the batch buckets' static buffers
# and graph pools (up to 7.5 MB for BERT-base on the H100, the 15a lines).
CUBLAS_WORKSPACE_BYTES = 32 << 20  # torch's default on sm_90 (":4096:8")
PLATFORM_NEW_WORKSPACES = 6
PLATFORM_SLACK_BYTES = 16 << 20
PLATFORM_CYCLES = 3  # iris applied, warmed and deleted, with no new workspace
PLATFORM_PLANTED_WAIT_S = 2.0  # how long a planted leak is given to be freed before its check fails


def _platform_cr(name: str, seed: int | None = None, rename: str | None = None) -> dict:
    """A deployment file as a user applies it: renamed where asked, OAuth
    credentials of its own where it was renamed or declares none, the
    model URI's seed set where asked."""
    cr = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    if rename is not None:
        cr["metadata"]["name"] = cr["spec"]["name"] = rename
    if rename is not None or not cr["spec"].get("oauth_key"):
        dep = cr["metadata"]["name"]
        cr["spec"]["oauth_key"], cr["spec"]["oauth_secret"] = f"{dep}-key", f"{dep}-secret"
    if seed is not None:
        for p in cr["spec"]["predictors"][0]["graph"]["parameters"]:
            if p["name"] == "model_uri":
                uri = re.sub(r"[?&]seed=\d+", "", p["value"])
                p["value"] = uri + ("&" if "?" in uri else "?") + f"seed={seed}"
    return cr


def _vocab(runtime) -> int:
    from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload

    table = runtime.params["tok_emb"]
    return (payload(table) if is_quantized_leaf(table) else table).shape[0]


def _write_cr(cr: dict, stem: str) -> Path:
    path = PLATFORM_DIR / f"{stem}.json"
    path.write_text(json.dumps(cr))
    return path


def _bandit_cr() -> dict:
    """An epsilon-greedy router over two iris models: the stateful router
    the state store carries across a re-apply."""
    return {"apiVersion": "machinelearning.seldon.io/v1alpha1", "kind": "SeldonDeployment",
            "metadata": {"name": "iris-bandit"},
            "spec": {"name": "iris-bandit", "oauth_key": "iris-bandit-key", "oauth_secret": "iris-bandit-secret",
                     "predictors": [{"name": "main", "replicas": 1, "graph": {
                         "name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
                         "parameters": [{"name": "epsilon", "value": "0.1", "type": "FLOAT"},
                                        {"name": "seed", "value": "7", "type": "INT"}],
                         "children": [{"name": f"clf{i}", "type": "MODEL", "implementation": "JAX_MODEL",
                                       "parameters": [{"name": "model_uri", "value": f"zoo://iris_logistic?seed={i}",
                                                       "type": "STRING"}]} for i in range(2)]},
                         "tpu": {"max_batch": 8, "dtype": "float32"}}]}}


def _allocated(net: bool = True) -> int:
    """memory_allocated() once everything unreachable is collected. Nothing
    is thawed: what the serving GC policy froze stays counted, so a version
    the platform dropped but left frozen shows. ``net``: less cuBLAS's
    workspaces (their count is bounded by the phase)."""
    import torch

    torch.cuda.synchronize()
    gc.collect()
    return torch.cuda.memory_allocated() - (CUBLAS_WORKSPACE_BYTES * _workspaces() if net else 0)


async def _stop_standalone(srv) -> None:
    """Stop a standalone server of the phase. Its start applied the serving
    GC policy, which froze the whole heap, its own objects with them; they
    are thawed and collected here, and what is alive is frozen again, as
    the platform's policy had it. The platform's tenants stay frozen."""
    await srv.stop()
    gc.unfreeze()
    gc.collect()
    gc.freeze()


def _workspaces() -> int:
    """Active blocks of exactly the cuBLAS workspace's size on the card."""
    import torch

    if DEVICE != "cuda":
        return 0
    return sum(1 for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
               if b["state"] == "active_allocated" and b["size"] == CUBLAS_WORKSPACE_BYTES)


async def _api(port: int, method: str, path: str, obj=None) -> tuple[int, dict]:
    from seldon_core_tpu_torch.operator.api import BASE

    body = b"" if obj is None else json.dumps(obj).encode()
    status, _, payload, _ = await _request(port, body, path=BASE + path, method=method)
    return status, json.loads(payload) if payload else {}


def _answer(out: dict) -> "np.ndarray":
    import numpy as np

    return np.asarray(out["data"]["ndarray"], np.float32)


async def _ask_server(port: int, x) -> "np.ndarray":
    status, _, raw, _ = await _request(port, json.dumps({"data": {"ndarray": x}}).encode())
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    return _answer(json.loads(raw))


async def _gate_ask(port: int, token: str, x) -> "np.ndarray":
    status, raw, _ = await _bearer_post(port, token, json.dumps({"data": {"ndarray": x}}).encode())
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    return _answer(json.loads(raw))


async def _versions(ask_rows, xs: list, bucket: int) -> list:
    """Per row of ``xs`` the answers a version gives it alone and inside a
    batch of ``bucket`` rows (the batcher pads every merged batch to the
    bucket, whose matmuls may round otherwise): ``ask_rows(rows)`` posts
    one request and returns its answer rows."""
    alone = [(await ask_rows([x]))[0] for x in xs]
    batched = []
    for i in range(0, len(xs), bucket):
        batched.extend(await ask_rows(xs[i:i + bucket]))
    return [(a.tobytes(), b.tobytes()) for a, b in zip(alone, batched)]


def check_swap(label: str, answers: list, after: list, old: list, new: list) -> None:
    """A hot update's answers: each (user, answer) bit for bit one of the
    old version's or the new one's answers for that user's row (``old`` and
    ``new``: per row, the bytes of each answer it can get), and each answer
    begun after apply returned one of the new one's."""
    for u, got in answers:
        if got.tobytes() not in old[u] + new[u]:
            raise AssertionError(f"{label}: user {u} was answered {got}, neither an answer of the old version "
                                 f"nor of the new one")
    for u, got in after:
        if got.tobytes() not in new[u]:
            raise AssertionError(f"{label}: user {u} was answered {got} after apply returned, not an answer of "
                                 f"the new version")


async def check_freed(label: str, refs: list, before: int, expected: int, diagnose: bool = True,
                      wait_s: float = 10.0) -> int:
    """A replaced or deleted version: every weak reference to its
    deployment, runtimes and graph caches dead (once its last requests and
    its batchers' drain have ended: up to ``wait_s``), and
    memory_allocated() within PLATFORM_SLACK_BYTES of ``expected``
    (``before`` is the reading before, for the message). The collections
    here thaw nothing. Returns the reading."""
    t0 = time.perf_counter()
    while True:
        gc.collect()
        alive = [name for name, ref in refs if ref() is not None]
        if not alive or time.perf_counter() - t0 > wait_s:
            break
        await asyncio.sleep(0.05)
    now = _allocated()
    if alive:
        held = {name: _holders(ref()) for name, ref in refs if ref() is not None} if diagnose else alive
        raise AssertionError(f"{label}: still reachable: {held}")
    if abs(now - expected) > PLATFORM_SLACK_BYTES:
        raise AssertionError(f"{label}: memory_allocated() {now} B (was {before}), want {expected} B "
                             f"+- {PLATFORM_SLACK_BYTES}")
    return now


def _holders(obj) -> list:
    """What refers to ``obj``, to name a leak: its reference count and the
    referrers the collector sees (a frame by function and line). Reads
    nothing that could keep a reference itself (no ``f_locals``)."""
    import types

    out = [f"refcount {sys.getrefcount(obj) - 2}"]
    for r in gc.get_referrers(obj):
        if isinstance(r, types.FrameType):
            out.append(f"frame {r.f_code.co_name} line {r.f_lineno}")
        elif isinstance(r, dict):
            out.append(f"dict {sorted(map(str, r))[:6]}")
        else:
            out.append(type(r).__qualname__)
    return out


def _refs(running) -> list:
    import weakref

    refs = [("deployment", weakref.ref(running))]
    for i, rt in enumerate(running.runtimes()):
        refs += [(f"runtime {i}", weakref.ref(rt)), (f"graph cache {i}", weakref.ref(rt.graphs))]
    return refs


async def _until(label: str, cond) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > PLATFORM_WAIT_S:
            raise AssertionError(f"{label}: not within {PLATFORM_WAIT_S} s")
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def platform_boot_and_apply(card, platform, warm, standalone: dict) -> dict:
    """Phase 15a: the three CRs through the operator API, each served
    through the gateway bit for bit as a standalone PredictorServer of the
    same file serves it on the same card, with the kernel launches counted
    per request (and per W8A16 body), 0 keys after each deployment's
    warmup (on the one thread of ``warm``), and per apply its seconds,
    memory_allocated() growth, resident parameter bytes and host estimate.
    The standalone servers' launches are added to ``standalone``."""
    import numpy as np

    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.operator.reconciler import estimate_deployment_bytes

    loop = asyncio.get_running_loop()
    rows, tokens = {}, {}
    for name in ("bert_base_flash", "bert_int8", "iris"):
        cr = _platform_cr(name)
        dep = cr["metadata"]["name"]
        before = _allocated()
        t0 = time.perf_counter()
        status, body = await _api(platform.admin_port, "POST", "", cr)
        apply_s = time.perf_counter() - t0
        if status != 200 or body["action"] != "created":
            raise AssertionError(f"15a apply {name}: HTTP {status} {body}")
        applied = _allocated()
        running = platform.manager.get(dep)
        t0 = time.perf_counter()
        await loop.run_in_executor(warm, running.warmup)
        warm_s = time.perf_counter() - t0
        rows[name] = {"apply_s": round(apply_s, 3), "warmup_s": round(warm_s, 3),
                      "allocated_growth_bytes": applied - before, "after_warmup_growth_bytes": _allocated() - before,
                      "resident_bytes": platform.manager.hbm_usage()["deployments"][dep],
                      "estimate_bytes": estimate_deployment_bytes(default_deployment(SeldonDeployment.from_dict(cr)))}
        tokens[name] = await _token(platform.port, "form", cr["spec"]["oauth_key"], cr["spec"]["oauth_secret"])
    rng = np.random.default_rng(15)
    for name in ("bert_base_flash", "bert_int8", "iris"):
        cr = _platform_cr(name)
        running = platform.manager.get(cr["metadata"]["name"])
        runtime = running.runtimes()[0]
        path = _write_cr(cr, f"standalone_{name}")
        window = (LAUNCHES.count, i8.LAUNCHES.count)
        deltas, by_body = [], []
        alone, *_ = await _start(path)
        try:
            for i in range(PLATFORM_REQUESTS):
                if name == "iris":
                    x = rng.normal(size=(1, 4)).round(3).tolist()
                else:
                    x = rng.integers(0, _vocab(runtime), size=(1, runtime.feature_shape[0])).tolist()
                flash0, int80 = LAUNCHES.count, i8.LAUNCHES.count
                bodies0 = {b: c.count for b, c in i8.LAUNCHES_BY_BODY.items()}
                got = await _gate_ask(platform.port, tokens[name], x)
                deltas.append((LAUNCHES.count - flash0, i8.LAUNCHES.count - int80))
                by_body.append({b: c.count - bodies0[b] for b, c in i8.LAUNCHES_BY_BODY.items()})
                status, _, raw, _ = await _request(alone.port, json.dumps({"data": {"ndarray": x}}).encode())
                if status != 200:
                    raise AssertionError(f"15a {name} standalone: HTTP {status} {raw[:200]!r}")
                _same_bits(f"15a {name} request {i}: the platform against a standalone server", got,
                           _answer(json.loads(raw)))
        finally:
            await _stop_standalone(alone)
        # the window's launches less the platform's requests' are the standalone server's
        standalone["flash_attention"] += LAUNCHES.count - window[0] - sum(d[0] for d in deltas)
        standalone["int8_matmul"] += i8.LAUNCHES.count - window[1] - sum(d[1] for d in deltas)
        if name == "bert_base_flash":
            require_launches("15a bert_base_flash flash_attention", [d[0] for d in deltas],
                             len(runtime.params["layers"]))
        elif name == "bert_int8":
            require_launches("15a bert_int8 int8_matmul", [d[1] for d in deltas], INT8_LAUNCHES)
            if by_body != [INT8_LAUNCHES_BY_BODY] * len(by_body):
                raise AssertionError(f"15a bert_int8 launches by body {by_body}, want {INT8_LAUNCHES_BY_BODY} each")
        keys = runtime.recompiles_since_warmup()
        if keys:
            raise AssertionError(f"15a {name}: {keys} new dispatch keys after warmup")
        rows[name].update(launches_per_request=deltas[0], keys_after_warmup=keys, cublas_workspaces=_workspaces())
        print(f"[{card}] 15a {name}: {json.dumps(rows[name])}; {PLATFORM_REQUESTS} answers through the gateway "
              f"bit for bit a standalone server's", flush=True)
    return {"deployments": rows, "tokens": tokens}


async def _swap_under_traffic(platform, port: int, token: str, xs: list, apply_fn, sibling=None) -> dict:
    """len(xs) users each asking its own row in a closed loop through the
    gateway while ``apply_fn()`` (a coroutine function) runs: every answer
    with whether it began after apply returned, failures counted, and the
    sibling's answers with their latencies in ms (``sibling``: (token, x),
    asked by PLATFORM_SIBLINGS more users)."""
    applied = asyncio.Event()
    answers, after, failures, sib, sib_ms = [], [], [], [], []

    async def user(u: int) -> None:
        while not applied.is_set() or len(after) < PLATFORM_AFTER:
            began_after = applied.is_set()
            try:
                got = await _gate_ask(port, token, [xs[u]])
            except Exception as e:  # noqa: BLE001 - every failure is counted
                failures.append(f"user {u}: {e!r}"[:300])
                continue
            answers.append((u, got))
            if began_after:
                after.append((u, got))

    async def sibling_user() -> None:
        while not applied.is_set() or len(after) < PLATFORM_AFTER:
            t0 = time.perf_counter()
            try:
                sib.append(await _gate_ask(port, sibling[0], sibling[1]))
            except Exception as e:  # noqa: BLE001
                failures.append(f"sibling: {e!r}"[:300])
                continue
            sib_ms.append((time.perf_counter() - t0) * 1e3)

    tasks = [asyncio.ensure_future(user(u)) for u in range(len(xs))]
    if sibling is not None:
        tasks += [asyncio.ensure_future(sibling_user()) for _ in range(PLATFORM_SIBLINGS)]
    t0 = time.perf_counter()
    try:
        await asyncio.sleep(0.2)  # the users are in flight before the apply
        result = await apply_fn()
        apply_s = time.perf_counter() - t0
    finally:
        applied.set()
        await asyncio.gather(*tasks, return_exceptions=True)
    return {"result": result, "answers": answers, "after": after, "failures": failures, "sibling": sib,
            "sibling_ms": sib_ms, "apply_s": apply_s}


def _quantiles_ms(ms: list) -> dict:
    import numpy as np

    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


async def platform_hot_update(card, platform, tokens: dict, warm, standalone: dict) -> dict:
    """Phase 15b: PLATFORM_USERS users on bert-base-flash through the
    gateway while it is re-applied with seed 1 and mnist applied beside it:
    no request fails, each answer is the old or the new version's (the new
    one's from a standalone server of the seed-1 CR), every answer begun
    after apply returned the new one's, iris (asked throughout by
    PLATFORM_SIBLINGS users, its p50 and p99 beside those of the same
    traffic for PLATFORM_QUIET_S without an apply) and bert-int8 do not
    move; the old version drained, unreachable though the serving GC
    policy froze it, the heap frozen again, and memory_allocated() back
    within the slack of the bytes the resident parameters account for.
    Planted: an update whose new version is built from the old spec (on
    iris) fails the answer check."""
    import numpy as np

    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    loop = asyncio.get_running_loop()
    manager = platform.manager
    rng = np.random.default_rng(16)
    runtime = manager.get("bert-base-flash").runtimes()[0]
    seq, vocab, bucket = runtime.feature_shape[0], _vocab(runtime), max(runtime.buckets)
    del runtime  # the old version must be collectable after the swap
    xs = rng.integers(0, vocab, size=(PLATFORM_USERS, seq)).tolist()
    old = await _versions(lambda rows: _gate_ask(platform.port, tokens["bert_base_flash"], rows), xs, bucket)
    iris_x = [[5.1, 3.5, 1.4, 0.2]]
    iris_before = await _gate_ask(platform.port, tokens["iris"], iris_x)
    int8_rt = manager.get("bert-int8").runtimes()[0]
    int8_x = rng.integers(0, _vocab(int8_rt), size=(1, int8_rt.feature_shape[0])).tolist()
    del int8_rt
    int8_before = await _gate_ask(platform.port, tokens["bert_int8"], int8_x)
    new_cr = _platform_cr("bert_base_flash", seed=1)
    window = (LAUNCHES.count, i8.LAUNCHES.count)
    alone, *_ = await _start(_write_cr(new_cr, "standalone_bert_seed1"))
    try:
        new = await _versions(lambda rows: _ask_server(alone.port, rows), xs, bucket)
    finally:
        await _stop_standalone(alone)
    standalone["flash_attention"] += LAUNCHES.count - window[0]
    standalone["int8_matmul"] += i8.LAUNCHES.count - window[1]
    if any(set(a) & set(b) for a, b in zip(old, new)):
        raise AssertionError("15b: seed 1 answers a row as seed 0 does")
    # the same traffic without an apply: the siblings' latency to hold the
    # apply's against, and every answer the old version's
    quiet = await _swap_under_traffic(platform, platform.port, tokens["bert_base_flash"], xs,
                                      lambda: asyncio.sleep(PLATFORM_QUIET_S), sibling=(tokens["iris"], iris_x))
    if quiet["failures"]:
        raise AssertionError(f"15b without an apply: {len(quiet['failures'])} failed requests, "
                             f"e.g. {quiet['failures'][:3]}")
    check_swap("15b without an apply", quiet["answers"], quiet["after"], old, old)
    refs = _refs(manager.get("bert-base-flash"))
    usage_before = manager.hbm_usage()["total"]
    refreezes = manager.release.stat_refreezes
    before = _allocated()

    async def apply_both():
        return await asyncio.gather(_api(platform.admin_port, "POST", "", new_cr),
                                    _api(platform.admin_port, "POST", "", _platform_cr("mnist")))

    run = await _swap_under_traffic(platform, platform.port, tokens["bert_base_flash"], xs, apply_both,
                                    sibling=(tokens["iris"], iris_x))
    (s1, b1), (s2, b2) = run["result"]
    if (s1, b1.get("action"), s2, b2.get("action")) != (200, "updated", 200, "created"):
        raise AssertionError(f"15b applies: {s1} {b1}, {s2} {b2}")
    if run["failures"]:
        raise AssertionError(f"15b: {len(run['failures'])} failed requests, e.g. {run['failures'][:3]}")
    check_swap("15b bert-base-flash", run["answers"], run["after"], old, new)
    for got in quiet["sibling"] + run["sibling"]:
        _same_bits("15b iris during the update", got, iris_before)
    _same_bits("15b bert-int8 after the update", await _gate_ask(platform.port, tokens["bert_int8"], int8_x),
               int8_before)
    n_old = sum(got.tobytes() in old[u] for u, got in run["answers"])
    # the old version drains as its last requests end; then it is unreachable
    expected = before + manager.hbm_usage()["total"] - usage_before
    after_bytes = await check_freed("15b the replaced bert-base-flash", refs, before, expected)
    await _until("15b the heap frozen again", lambda: manager.release.stat_refreezes > refreezes
                 and not manager.release.pending())
    new_running = manager.get("bert-base-flash")
    await loop.run_in_executor(warm, new_running.warmup)
    del new_running
    row = {"requests": len(run["answers"]), "answered_by_old": n_old, "after_apply": len(run["after"]),
           "failures": 0, "apply_s": round(run["apply_s"], 3),
           "sibling_iris": {"without_apply": _quantiles_ms(quiet["sibling_ms"]),
                            "during_apply": _quantiles_ms(run["sibling_ms"])},
           "release_collect_s": manager.release.stat_collect_s[-3:], "cublas_workspaces": _workspaces(),
           "allocated_before": before, "allocated_after": after_bytes, "expected_after": expected,
           "slack_bytes": PLATFORM_SLACK_BYTES}

    # planted: the update's new version built from the old spec
    iris_old, iris_new = _platform_cr("iris", rename="iris-planted"), _platform_cr("iris", rename="iris-planted")
    iris_new["spec"]["predictors"][0]["graph"]["parameters"] = [
        {"name": "model_uri", "value": "zoo://iris_logistic?seed=1", "type": "STRING"}]
    status, body = await _api(platform.admin_port, "POST", "", iris_old)
    token = await _token(platform.port, "form", iris_old["spec"]["oauth_key"], iris_old["spec"]["oauth_secret"])
    ixs = rng.normal(size=(1, 4)).round(3).tolist()  # one user: every batch at bucket 1
    iold = await _versions(lambda rows: _gate_ask(platform.port, token, rows), ixs, 1)
    alone, *_ = await _start(_write_cr(iris_new, "standalone_iris_seed1"))
    try:
        inew = await _versions(lambda rows: _ask_server(alone.port, rows), ixs, 1)
    finally:
        await _stop_standalone(alone)
    real = manager._service_factory
    old_dep = manager.get("iris-planted").dep
    manager._service_factory = lambda dep, pred: real(old_dep, old_dep.spec.predictors[0])
    try:
        planted = await _swap_under_traffic(platform, platform.port, token, ixs,
                                            lambda: _api(platform.admin_port, "POST", "", iris_new))
    finally:
        manager._service_factory = real
    if planted["failures"] or planted["result"][0] != 200:
        raise AssertionError(f"15b planted update: {planted['result']} {planted['failures'][:3]}")
    must_fail("15b an update whose new version answers with the old weights",
              lambda: check_swap("15b planted", planted["answers"], planted["after"], iold, inew))
    status, body = await _api(platform.admin_port, "DELETE", "/iris-planted")
    print(f"[{card}] 15b hot update under {PLATFORM_USERS} users: {json.dumps(row)}", flush=True)
    return row


async def platform_admission_and_delete(card, platform, base: int, warm) -> dict:
    """Phase 15c: a budget the tenants fit and a second BERT-base (seed 2)
    does not: the apply is refused with the reference's "insufficient HBM"
    text and memory_allocated() is exactly unchanged; bert-int8 deleted
    (with its graph cache held by a planted leak, the freed check must
    fail; released, it passes); bert-base-flash deleted (with the heap's
    thaw planted out, the version stays frozen and the freed check must
    fail; thawed, it passes) and the refused spec then reconciles; every
    tenant deleted, the heap frozen again after the deletes, and
    memory_allocated() back within the slack of its reading before 15a
    (``base``)."""
    import torch

    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.operator.reconciler import estimate_deployment_bytes
    from seldon_core_tpu_torch.ops import graphs

    manager = platform.manager
    second = _platform_cr("bert_base_flash", seed=2, rename="bert-base-second")
    incoming = estimate_deployment_bytes(default_deployment(SeldonDeployment.from_dict(second)))
    manager.hbm_budget_bytes = manager.hbm_usage()["total"] + incoming // 2
    before = _allocated(net=False)
    t0 = time.perf_counter()
    status, body = await _api(platform.admin_port, "POST", "", second)
    refuse_s = time.perf_counter() - t0
    refused_bytes = _allocated(net=False)
    if status != 400 or body["action"] != "failed" or "insufficient HBM" not in body["message"]:
        raise AssertionError(f"15c the over-budget apply: HTTP {status} {body}")
    if refused_bytes != before:
        raise AssertionError(f"15c the refused apply moved memory_allocated() from {before} to {refused_bytes}")
    status_of = manager.status("bert-base-second")
    row = {"budget": manager.hbm_budget_bytes, "incoming_estimate": incoming, "refused_s": round(refuse_s, 3),
           "refusal": body["message"], "status": status_of.state}

    # planted: a delete that leaves the graph cache reachable
    running = manager.get("bert-int8")
    refs, resident = _refs(running), manager.hbm_usage()["deployments"]["bert-int8"]
    leak = [running.runtimes()[0].graphs]
    del running
    before = _allocated()
    status, body = await _api(platform.admin_port, "DELETE", "/bert-int8")
    if status != 200 or body["action"] != "deleted":
        raise AssertionError(f"15c delete bert-int8: HTTP {status} {body}")
    await must_fail_async("15c a delete that leaves a graph cache reachable",
                          lambda: check_freed("15c planted", refs, before, before - resident, diagnose=False,
                                              wait_s=PLATFORM_PLANTED_WAIT_S))
    leak.clear()
    row["int8_freed_bytes"] = before - await check_freed("15c the deleted bert-int8", refs, before,
                                                         before - resident)

    # planted: the release's thaw taken out, so the deleted version stays
    # in the generation the serving GC policy froze
    running = manager.get("bert-base-flash")
    refs, resident = _refs(running), manager.hbm_usage()["deployments"]["bert-base-flash"]
    del running
    before = _allocated()
    real_unfreeze = gc.unfreeze
    gc.unfreeze = lambda: None
    try:
        status, body = await _api(platform.admin_port, "DELETE", "/bert-base-flash")
    finally:
        gc.unfreeze = real_unfreeze
    if status != 200 or body["action"] != "deleted":
        raise AssertionError(f"15c delete bert-base-flash: HTTP {status} {body}")
    await must_fail_async("15c a delete that leaves the version frozen",
                          lambda: check_freed("15c planted", refs, before, before - resident, diagnose=False,
                                              wait_s=PLATFORM_PLANTED_WAIT_S))
    gc.unfreeze()
    row["flash_freed_bytes"] = before - await check_freed("15c the deleted bert-base-flash", refs, before,
                                                          before - resident)
    status, body = await _api(platform.admin_port, "POST", "", second)
    if status != 200 or body["action"] != "created":
        raise AssertionError(f"15c the refused spec after a delete: HTTP {status} {body}")
    manager.hbm_budget_bytes = None
    refs, refreezes = [], manager.release.stat_refreezes
    for name in manager.names():
        refs += [(f"{name} {n}", r) for n, r in _refs(manager.get(name))]
        status, body = await _api(platform.admin_port, "DELETE", f"/{name}")
        if status != 200:
            raise AssertionError(f"15c delete {name}: HTTP {status} {body}")
    row["allocated_before_15a"] = base
    row["allocated_after_deletes"] = await check_freed("15c every tenant deleted", refs, base, base)
    await _until("15c the heap frozen again", lambda: manager.release.stat_refreezes > refreezes
                 and not manager.release.pending())
    row["refreezes"] = manager.release.stat_refreezes
    row["release_collect_s"] = manager.release.stat_collect_s[-4:]
    row["cublas_workspaces_after"] = _workspaces()

    # applies and deletes take no new cuBLAS workspace: after one warm-in
    # cycle, PLATFORM_CYCLES more of an iris copy (applied, warmed on the
    # one warmup thread, deleted) take none; planted, a new capture stream
    # per graph cache takes one a cycle (on the card; the CPU has none)
    await _platform_cycles(platform, warm, 1)
    row["cycle_new_workspaces"] = await _platform_cycles(platform, warm, PLATFORM_CYCLES)
    check_workspaces("15c applies and deletes", row["cycle_new_workspaces"])
    real_stream = graphs._capture_stream
    graphs._capture_stream = torch.cuda.Stream
    try:
        planted = await _platform_cycles(platform, warm, PLATFORM_CYCLES)
    finally:
        graphs._capture_stream = real_stream
    if DEVICE == "cuda":
        must_fail("15c a new capture stream per graph cache", lambda: check_workspaces("15c planted", planted))
    row["planted_new_workspaces"] = planted
    print(f"[{card}] 15c admission and delete: {json.dumps(row)}", flush=True)
    return row


async def _platform_cycles(platform, warm, n: int) -> int:
    """``n`` times an iris copy applied, warmed on ``warm``'s thread and
    deleted, each drop collected: the new cuBLAS workspaces."""
    manager = platform.manager
    before = _workspaces()
    for _ in range(n):
        status, body = await _api(platform.admin_port, "POST", "", _platform_cr("iris", rename="iris-cycle"))
        if status != 200 or body["action"] != "created":
            raise AssertionError(f"15c cycle apply: HTTP {status} {body}")
        await asyncio.get_running_loop().run_in_executor(warm, manager.get("iris-cycle").warmup)
        status, body = await _api(platform.admin_port, "DELETE", "/iris-cycle")
        if status != 200:
            raise AssertionError(f"15c cycle delete: HTTP {status} {body}")
        await _until("15c the cycle's version collected", lambda: not manager.release.pending())
    return _workspaces() - before


def check_workspaces(label: str, new: int) -> None:
    if new:
        raise AssertionError(f"{label}: {new} new cuBLAS workspaces, want 0")


async def platform_watch_dir(card, platform, watch_dir: Path) -> dict:
    """Phase 15d: an epsilon-greedy CR file dropped into the watched
    directory serves through the gateway; three feedbacks teach its router;
    a torn rewrite keeps it serving; a changed spec re-applies it with the
    router's arms restored from the file state store; removing the file
    deletes it."""
    manager = platform.manager
    cr = _bandit_cr()
    t0 = time.perf_counter()
    (watch_dir / "bandit.json").write_text(json.dumps(cr))
    await _until("15d the dropped CR file", lambda: "iris-bandit" in manager.names())
    applied_s = time.perf_counter() - t0
    token = await _token(platform.port, "form", cr["spec"]["oauth_key"], cr["spec"]["oauth_secret"])
    x = [[5.1, 3.5, 1.4, 0.2]]
    for reward in (1.0, 0.0, 1.0):
        status, raw, _ = await _bearer_post(platform.port, token, json.dumps({"data": {"ndarray": x}}).encode())
        out = json.loads(raw)
        fb = json.dumps({"request": {"data": {"ndarray": x}}, "response": out, "reward": reward}).encode()
        status, fraw, _ = await _bearer_post(platform.port, token, fb, path="/api/v0.1/feedback")
        if status != 200:
            raise AssertionError(f"15d feedback: HTTP {status} {fraw[:200]!r}")
    router = manager.get("iris-bandit").services["main"].executor.root.unit
    arms = (list(router.counts), list(router.rewards))
    if sum(arms[0]) != 3:
        raise AssertionError(f"15d the router counted {arms[0]} feedbacks, want 3")
    (watch_dir / "bandit.json").write_text(json.dumps(cr)[:40])  # torn mid-write
    await asyncio.sleep(4 * PLATFORM_WATCH_S)
    if "iris-bandit" not in manager.names():
        raise AssertionError("15d a torn rewrite deleted the deployment")
    await _gate_ask(platform.port, token, x)
    cr["spec"]["predictors"][0]["replicas"] = 2
    (watch_dir / "bandit.json").write_text(json.dumps(cr))
    await _until("15d the rewritten CR", lambda: manager.get("iris-bandit") is not None
                 and manager.get("iris-bandit").dep.spec.predictors[0].replicas == 2)
    restored = manager.get("iris-bandit").services["main"].executor.root.unit
    if restored is router or (list(restored.counts), list(restored.rewards)) != arms:
        raise AssertionError(f"15d the re-applied router holds {restored.counts}/{restored.rewards}, want {arms}")
    await _gate_ask(platform.port, token, x)
    (watch_dir / "bandit.json").unlink()
    deleted_s = await _until("15d the removed CR file", lambda: "iris-bandit" not in manager.names())
    row = {"applied_s": round(applied_s, 3), "arms": arms, "deleted_s": round(deleted_s, 3)}
    print(f"[{card}] 15d directory watcher and state store: {json.dumps(row)}", flush=True)
    return row


async def platform_profiler_and_codec(card, platform, tokens: dict) -> dict:
    """Phase 15e: POST /profiler/start?duration_ms= over three BERT-base
    requests writes a Chrome trace naming the flash kernel's symbol; the
    native codec's counters show C head parses and C ndarray parses of
    bodies over 4096 bytes; a head with two Accept headers is served by the
    last (and a scan planted to keep the first fails); iris's 1-user p50
    and 16-user predictions/s with the codec against the same server with
    the library off in-process, in turns."""
    import numpy as np

    from seldon_core_tpu_torch import native
    from seldon_core_tpu_torch.serving import fast_http

    trace_dir = PLATFORM_DIR / "profile"
    status, _, raw, _ = await _request(platform.admin_port, b"",
                                       path=f"/profiler/start?dir={trace_dir}&duration_ms=3000")
    if status != 200:
        raise AssertionError(f"15e profiler start: HTTP {status} {raw[:200]!r}")
    runtime = platform.manager.get("bert-base-flash").runtimes()[0]
    rng = np.random.default_rng(17)
    seq, vocab = runtime.feature_shape[0], _vocab(runtime)
    for _ in range(3):
        await _gate_ask(platform.port, tokens["bert_base_flash"], rng.integers(0, vocab, size=(1, seq)).tolist())
    def written() -> bool:
        try:
            return bool(json.loads((trace_dir / "trace.json").read_text())["traceEvents"])
        except (OSError, ValueError, KeyError):
            return False  # not yet written, or still being written

    waited = await _until("15e the profiler's auto-stop", written)
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = sorted({e.get("name", "") for e in events if e.get("cat") == "kernel"})
    flash = [k for k in kernels if "flash_fwd" in k]
    if DEVICE == "cuda" and not flash:
        raise AssertionError(f"15e the trace names no flash kernel; kernels {kernels[:20]}")

    # a body over 4096 bytes (4 BERT-base rows; more at a smaller width)
    # through the C ndarray parse
    n_big = max(4, -(-4200 // len(json.dumps(rng.integers(vocab // 2, vocab, size=seq).tolist()))))
    big = json.dumps({"data": {"ndarray": rng.integers(vocab // 2, vocab, size=(n_big, seq)).tolist()}}).encode()
    stats0 = native.stats()["entries"]
    status, raw, _ = await _bearer_post(platform.port, tokens["bert_base_flash"], big)
    _check_probs(json.loads(raw), n_big)
    stats1 = native.stats()
    if not stats1["available"]:
        raise AssertionError("15e the native codec is not available on this host")
    if len(big) <= 4096 or stats1["entries"]["parse_ndarray"]["c"] <= stats0["parse_ndarray"]["c"]:
        raise AssertionError(f"15e a {len(big)}-byte body took no C ndarray parse: {stats1}")
    if stats1["entries"]["parse_http_head"]["c"] <= 0:
        raise AssertionError(f"15e no C head parse: {stats1}")

    async def accept_check(label: str) -> None:
        heads0 = native.stats()["entries"]["parse_http_head"]["c"]
        status, hdrs, _, _ = await _request(platform.port, b"", path="/metrics", method="GET", headers={
            "Accept": "application/openmetrics-text", "accept": "text/plain"})
        if native.stats()["entries"]["parse_http_head"]["c"] <= heads0:
            raise AssertionError(f"{label}: the head was not parsed in C")
        if status != 200 or not hdrs.get("content-type", "").startswith("text/plain"):
            raise AssertionError(f"{label}: two Accept headers answered {hdrs.get('content-type')}, want the "
                                 f"last one's text/plain")

    await accept_check("15e duplicate headers")
    real = fast_http._header_from_head

    def first_wins(head: bytes, name: bytes):
        target = name + b":"
        for line in head.split(b"\r\n")[1:]:
            if line[: len(target)].lower() == target:
                return line[len(target):].strip(b" \t").decode("latin-1")
        return None

    fast_http._header_from_head = first_wins
    try:
        await must_fail_async("15e a C-parsed head that keeps the first duplicate header",
                              lambda: accept_check("15e planted"))
    finally:
        fast_http._header_from_head = real

    load = {"payload": "json", "features": 4, "oauth": ("iris-key", "iris-secret")}
    runs = {"c": [], "python": []}
    for turn in PLATFORM_LOAD_TURNS:
        with contextlib.ExitStack() as stack:
            if turn == "python":
                stack.enter_context(native.python_only())
            point = {}
            for users in SPLIT_LOAD:
                point[users] = await _load_point(platform.port, users, load)
                print(f"[{card}] load 15e iris codec={turn} users={users} {json.dumps(point[users])}", flush=True)
            runs[turn].append(point)
    row = {"trace_events": len(events), "flash_kernels_in_trace": flash[:3], "auto_stop_waited_s": round(waited, 3),
           "codec": stats1["entries"], "load": _turns_summary(runs)}
    print(f"[{card}] 15e profiler and codec: {json.dumps(row)}", flush=True)
    return row


async def serve_platform(card) -> dict:
    """Phase 15: the all-in-one platform on the card (``platform.py``):
    15a boot and apply, 15b the hot update under load, 15e the profiler
    and the codec (while BERT-base still serves), 15c admission and
    delete, 15d the directory watcher and the state store. Returns the
    phase's numbers and its launches."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from seldon_core_tpu_torch import native
    from seldon_core_tpu_torch.ops import int8_matmul
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.platform import Platform

    if PLATFORM_DIR.exists():
        shutil.rmtree(PLATFORM_DIR)
    watch_dir = PLATFORM_DIR / "watch"
    watch_dir.mkdir(parents=True)
    # what earlier phases' servers froze and left is freed before the base
    # reading; from here on nothing is thawed but by the platform
    gc.unfreeze()
    base = _allocated()
    workspaces = _workspaces()
    warm = ThreadPoolExecutor(1, thread_name_prefix="platform-warmup")  # every warmup's captures on one thread
    standalone = {"flash_attention": 0, "int8_matmul": 0}  # the standalone servers' launches
    native.reset_stats()
    int8_matmul.reset_launches()
    LAUNCHES.reset()  # the phase's paths run from here
    t0 = time.perf_counter()
    platform = Platform(device=DEVICE, audit_sink_url="mem://", state_store_url=f"file://{PLATFORM_DIR / 'state'}")
    await platform.serve("127.0.0.1", 0, grpc_port=None, watch_dir=str(watch_dir), watch_interval_s=PLATFORM_WATCH_S,
                         fast_ingress=True, admin_port=0)
    boot_s = time.perf_counter() - t0
    try:
        applied = await platform_boot_and_apply(card, platform, warm, standalone)
        tokens = applied["tokens"]
        update = await platform_hot_update(card, platform, tokens, warm, standalone)
        codec = await platform_profiler_and_codec(card, platform, tokens)
        admission = await platform_admission_and_delete(card, platform, base, warm)
        watch = await platform_watch_dir(card, platform, watch_dir)
        end = _allocated()
        if abs(end - base) > PLATFORM_SLACK_BYTES:
            raise AssertionError(f"15: memory_allocated() {end} B at the end, {base} B before the phase")
        new_workspaces = _workspaces() - workspaces - admission["planted_new_workspaces"]
        if new_workspaces > PLATFORM_NEW_WORKSPACES:
            raise AssertionError(f"15: {new_workspaces} new cuBLAS workspaces over the phase, at most "
                                 f"{PLATFORM_NEW_WORKSPACES}")
    finally:
        await platform.stop()
        warm.shutdown()
    # the platform's own launches: every launch since the reset less the
    # standalone servers' (the twins its answers are held against)
    by_body = {b: c.count for b, c in int8_matmul.LAUNCHES_BY_BODY.items()}
    return {"boot_s": round(boot_s, 3), "cublas_workspaces": {"before": workspaces, "new": new_workspaces},
            "apply": applied["deployments"], "hot_update": update, "admission": admission,
            "watch": watch, "profiler_and_codec": codec,
            "launches": {"flash_attention": LAUNCHES.count - standalone["flash_attention"],
                         "int8_matmul": int8_matmul.LAUNCHES.count - standalone["int8_matmul"],
                         "int8_by_body_with_standalone": by_body},
            "standalone_launches": standalone}


# ---------------------------------------------------------------- phase 16
TOOLS_DIR = ROOT / "build" / "tools"  # git-ignored: the wrap bundle and the platform's watched directory, per run
SOAK_MODEL = "bert_base?seq=512&attn_kernel=pallas"  # the soak's --model: BERT-base at full width, float32
SOAK_FEATURES = 512
SOAK_BATCH = 4  # rows per request
SOAK_USERS = 16
SOAK_SECONDS = 20.0  # the clean soak's load window
# the soak with the two planted leaks, after the clean one in the same
# process: the heap's free pool the clean soak leaves takes the first ~15 MB
# of kept bodies (6 s read +20.3 MB/min of RSS on the H100, PERF.md), so
# the host plant keeps SOAK_HOST_PLANT_COPIES copies of each body: about
# 8x a pool that size over the window
SOAK_LEAK_SECONDS = 12.0
SOAK_HOST_PLANT_COPIES = 8
SOAK_SAMPLE_S = 0.5  # memory_allocated() sampling interval over the load window
SOAK_ANSWER_ROWS = 4
# The soak's spec served standalone, float32 probabilities against the same
# weights with blockwise attention and with the kernel's plain version in
# its place (TF32 off): float32 sums in another order through 12 layers.
# A wrong attention (uniform, a 5% normaliser error, one dropped KV tile)
# moved phase 3's bf16 answers by 0.026 to 0.040; each must land outside.
F32_SERVE_ATOL = 1e-3
# Slope bounds (MB per minute, least squares): the soak's RSS slope net of
# the load generator's own growth, and memory_allocated() over the load
# window after warmup, on the clean soak, and with both leaks planted (a
# card-side clone of each batch's input, each request body kept on the
# host), each of which must pass its bound. H100 readings: PERF.md.
SOAK_RSS_SLOPE_MB_PER_MIN = 30.0
SOAK_DEVICE_SLOPE_MB_PER_MIN = 8.0
# 16b: the Makefile's chaos-smoke and kvtier-smoke arguments
SOAK_CHAOS_ARGS = ["--duration", "6", "--users", "4", "--replicas", "2", "--kill-replica", "0@2"]
SOAK_KV_ARGS = ["--duration", "3", "--users", "4", "--kv-overflow"]
WRAP_ROUNDS = 3


def _slope_mb_per_min(samples: list) -> float:
    """Least-squares slope of (seconds, bytes) samples in MB per minute."""
    if len(samples) < 2:
        return 0.0
    t0 = samples[0][0]
    xs = [(t - t0) / 60.0 for t, _ in samples]
    ys = [b / 1e6 for _, b in samples]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    denom = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom if denom > 0 else 0.0


async def soak_answer(card) -> dict:
    """16a, first: the spec ``soak()`` builds for SOAK_MODEL (float32, no
    ``tpu`` block) on a standalone PredictorServer: one request of
    SOAK_ANSWER_ROWS rows, 12 flash launches, its probabilities against the
    same weights with blockwise attention and with the kernel's plain
    version within F32_SERVE_ATOL, three wrong attentions outside it."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.bert import apply_for_kernel, make_apply_bert
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.server import PredictorServer
    from seldon_core_tpu_torch.tools.soak import soak_predictor

    predictor, _, _, generative = soak_predictor(model=SOAK_MODEL, features=SOAK_FEATURES)
    if generative or predictor.tpu.dtype != "float32":
        raise AssertionError(f"16a: the soak's spec for {SOAK_MODEL} is not a float32 classifier: {predictor.tpu}")
    server = PredictorServer(predictor, deployment_name="soak", device=DEVICE)
    server.warmup()
    runtime = _model_runtime(server)
    layers = len(runtime.params["layers"])
    ids = np.random.default_rng(16).integers(0, _vocab(runtime), size=(SOAK_ANSWER_ROWS, SOAK_FEATURES))
    await server.start("127.0.0.1", 0)
    try:
        before = LAUNCHES.count
        status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
        delta = LAUNCHES.count - before
    finally:
        await _stop_standalone(server)
    if status != 200:
        raise AssertionError(f"16a soak spec: HTTP {status} {out}")
    probs = _check_probs(out, SOAK_ANSWER_ROWS)
    require_launches("16a soak spec flash_attention", [delta], layers)
    applies = {"blockwise": apply_for_kernel("blockwise"), "plain_version": make_apply_bert(plain_attention)}
    controls = {name: make_apply_bert(fn) for name, fn in wrong_attentions().items()}
    with torch.inference_mode():
        x = torch.from_numpy(ids.astype(np.int32)).to(runtime.device)
        got = {name: apply(runtime.params, x).float().cpu().numpy() for name, apply in {**applies, **controls}.items()}
    worst = {name: float(np.abs(probs - g).max()) for name, g in got.items()}
    row = {"dtype": str(runtime.dtype).removeprefix("torch."), "layers": layers, "buckets": list(runtime.buckets),
           "latency_ms": round(ms, 3), "launches": delta, "max_abs_diff": worst, "atol": F32_SERVE_ATOL}
    print(f"[{card}] 16a soak spec {SOAK_MODEL} standalone: {json.dumps(row)}", flush=True)
    if max(worst["blockwise"], worst["plain_version"]) > F32_SERVE_ATOL:
        raise AssertionError(f"16a: float32 answers disagree with the same weights run another way: {worst}")
    for name in controls:
        if worst[name] <= F32_SERVE_ATOL:
            raise AssertionError(f"16a: the answer check cannot see a wrong attention ({name}: {worst[name]})")
    del runtime, server, x
    return row


async def soak_on_card(card, seconds: float, plant: bool = False) -> dict:
    """16a: ``soak()`` of SOAK_MODEL through the port's gateway stack on the
    card, in this process, with memory_allocated() sampled every
    SOAK_SAMPLE_S over the load window (samples before the soak's server
    finished its warmup are dropped), its flash launches counted from then
    on, and the batch buckets the load reached. ``plant``: a unit that
    keeps a card-side clone of each batch's input, and a path that keeps
    SOAK_HOST_PLANT_COPIES copies of each request body on the host."""
    import collections

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.base import bucket_for
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving import fast_http
    from seldon_core_tpu_torch.tools import soak as soak_mod
    from seldon_core_tpu_torch.tools import stack

    ready: dict = {}
    buckets: collections.Counter = collections.Counter()
    kept_device, kept_host = [], []
    build, routes = stack.build_gateway_stack, fast_http.gateway_routes

    def build_counted(*args, **kwargs):
        out = build(*args, **kwargs)
        runtime = _model_runtime(out[0])
        inner = runtime.predict_device

        def predict_device(x):
            buckets[bucket_for(len(x), runtime.buckets)] += 1
            if plant:
                kept_device.append(torch.from_numpy(np.asarray(x, np.int32)).to(runtime.device))
            return inner(x)

        runtime.predict_device = predict_device
        torch.cuda.synchronize()
        ready.update(t=time.perf_counter(), launches=LAUNCHES.count)
        return out

    def routes_kept(gw):
        table = routes(gw)
        if plant:
            handler = table[("POST", "/api/v0.1/predictions")]

            async def keep(req):
                kept_host.append(bytes(req.body) * SOAK_HOST_PLANT_COPIES)
                return await handler(req)

            table[("POST", "/api/v0.1/predictions")] = keep
        return table

    samples: list = []
    stop = asyncio.Event()

    async def sampler():
        while not stop.is_set():
            samples.append((time.perf_counter(), torch.cuda.memory_allocated()))
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop.wait(), SOAK_SAMPLE_S)

    stack.build_gateway_stack, fast_http.gateway_routes = build_counted, routes_kept
    task = asyncio.ensure_future(sampler())
    try:
        out = await soak_mod.soak(duration_s=seconds, users=SOAK_USERS, model=SOAK_MODEL, features=SOAK_FEATURES,
                                  batch=SOAK_BATCH, device=DEVICE)
    finally:
        stop.set()
        await task
        stack.build_gateway_stack, fast_http.gateway_routes = build, routes
    # the stack's boot froze the heap (the serving GC policy): thaw it so
    # the soak's server, which soak() leaves as a cycle, is collected
    kept_bytes = sum(t.numel() * t.element_size() for t in kept_device)
    kept_host_bytes = sum(len(b) for b in kept_host)
    del kept_device, kept_host
    gc.unfreeze()
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    window = [(t, b) for t, b in samples if t >= ready["t"]]
    row = {"planted": plant, "seconds": seconds, "preds_per_sec": out["preds_per_sec"], "p99_ms": out["p99_ms"],
           "errors": out["errors"], "loop_lag_p99_ms": out["loop_lag_p99_ms"],
           "rss_slope_net_mb_per_min": out["rss_slope_net_mb_per_min"],
           "rss_slope_mb_per_min": out["rss_slope_mb_per_min"],
           "device_slope_mb_per_min": round(_slope_mb_per_min(window), 3),
           "device_mb_start": round(window[0][1] / 1e6, 3) if window else None,
           "device_mb_end": round(window[-1][1] / 1e6, 3) if window else None,
           "device_samples": len(window), "launches": LAUNCHES.count - ready["launches"],
           "buckets_reached": dict(sorted(buckets.items())),
           "device_mb_after_collect": round(torch.cuda.memory_allocated() / 1e6, 3),
           "kept_device_mb": round(kept_bytes / 1e6, 3), "kept_host_mb": round(kept_host_bytes / 1e6, 3)}
    return row


def _soak_limits(row: dict) -> dict:
    return {"rss": row["rss_slope_net_mb_per_min"] > SOAK_RSS_SLOPE_MB_PER_MIN,
            "device": row["device_slope_mb_per_min"] > SOAK_DEVICE_SLOPE_MB_PER_MIN}


def _recompiles(obj) -> list:
    """Every ``recompiles_after_warmup`` in a soak report."""
    if isinstance(obj, dict):
        return [v for k, v in obj.items() if k == "recompiles_after_warmup"] + [
            x for v in obj.values() for x in _recompiles(v)]
    if isinstance(obj, list):
        return [x for v in obj for x in _recompiles(v)]
    return []


def soak_cli(card, label: str, args: list) -> tuple[int, dict | None, str]:
    """The port's soak CLI in a process of its own on the card."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.tools.soak", *args,
                        *([] if DEVICE == "cuda" else ["--device", DEVICE])],
                       capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    lines = r.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    print(f"[{card}] 16b soak {label} ({' '.join(args)}): exit {r.returncode} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return r.returncode, out, r.stderr


def soak_legs(card) -> dict:
    """16b: the generative soak legs on the card, as processes: the chaos
    leg (a replica killed under load) and the KV-overflow leg pass the
    soak's own gates and these checks; ``--tp 2`` on one card (the CLI's
    positions are the host's cards) is refused by name."""
    from concurrent.futures import ThreadPoolExecutor

    rows = {}
    legs = (("chaos", SOAK_CHAOS_ARGS), ("kv_overflow", SOAK_KV_ARGS))
    with ThreadPoolExecutor(len(legs)) as pool:  # the two processes run together
        runs = list(pool.map(lambda leg: soak_cli(card, *leg), legs))
    for (label, args), (rc, out, err) in zip(legs, runs):
        if rc != 0:
            raise AssertionError(f"16b soak {label}: exit {rc}: {err[-2000:]}")
        recompiles = _recompiles(out)
        row = {"preds_per_sec": out["preds_per_sec"], "p99_ms": out["p99_ms"], "errors": out["errors"],
               "loop_lag_p99_ms": out["loop_lag_p99_ms"], "rss_slope_net_mb_per_min": out["rss_slope_net_mb_per_min"],
               "recompiles_after_warmup": recompiles}
        if label == "chaos":
            row.update({k: out["chaos"][k] for k in ("evictions", "recoveries", "migrations", "replica_states")})
            ok = out["chaos"]["evictions"] >= 1 and out["chaos"]["recoveries"] >= 1
        else:
            row.update({k: out["kv_tier"][k] for k in ("demotions", "promotions", "promote_overlap")})
            ok = out["kv_tier"]["demotions"] >= 1 and out["kv_tier"]["promotions"] >= 1
        print(f"[{card}] 16b soak {label}: {json.dumps(row)}", flush=True)
        if out["errors"] != 0 or not ok or not recompiles or any(recompiles):
            raise AssertionError(f"16b soak {label} failed its checks: {row}")
        rows[label] = row
    rc, out, err = soak_cli(card, "tp", ["--tp", "2"])
    if rc == 0 or "decode_mesh_axes" not in err:
        raise AssertionError(f"16b soak --tp 2: exit {rc}, stderr {err[-500:]!r}: not refused by name")
    rows["tp_refused"] = err.strip().splitlines()[-1]
    print(f"[{card}] 16b soak --tp 2 refused: {rows['tp_refused']}", flush=True)
    return rows


def _platform_command(watch_dir: Path) -> tuple[list, dict]:
    """The install bundle's platform container as rendered (``build_bundle``,
    no YAML): its command with the three ports swapped for free ones and
    ``--watch-k8s --k8s-namespace NS`` for ``--watch-dir``, every other
    flag kept; returns (command, {rendered port: free port})."""
    from seldon_core_tpu_torch.tools.install import build_bundle

    bundle = build_bundle()
    dep = next(m for m in bundle if m["kind"] == "Deployment" and m["metadata"]["name"] == "seldon-core-tpu-platform")
    pod = dep["spec"]["template"]
    container = pod["spec"]["containers"][0]
    named = {p["name"]: p["containerPort"] for p in container["ports"]}
    swap = {port: _free_port() for port in named.values()}
    cmd = list(container["command"])
    if cmd[:3] != ["python", "-m", "seldon_core_tpu_torch.platform"]:
        raise AssertionError(f"16c: the rendered platform command is {cmd}")
    i = cmd.index("--watch-k8s")
    if cmd[i + 1] != "--k8s-namespace":
        raise AssertionError(f"16c: the rendered watch flags are {cmd[i:]}")
    cmd[i:i + 3] = ["--watch-dir", str(watch_dir)]
    for flag in ("--port", "--grpc-port", "--admin-port"):
        j = cmd.index(flag)
        cmd[j + 1] = str(swap[int(cmd[j + 1])])
    if DEVICE != "cuda":
        cmd += ["--device", DEVICE]
    return cmd, {"swap": swap, "named": named, "probe": container["readinessProbe"]["httpGet"],
                 "annotations": pod["metadata"]["annotations"]}


async def bundle_platform(card) -> dict:
    """16c: the install bundle's platform command as a process on the card:
    the rendered readiness probe and Prometheus scrape answer 200 on the
    swapped ports, and an ``iris`` CR applied through the admin port's
    operator API answers through the data port bit for bit what an
    in-process server of the same file answers."""
    import shutil

    import numpy as np

    watch_dir = TOOLS_DIR / "watch"
    if watch_dir.exists():
        shutil.rmtree(watch_dir)
    watch_dir.mkdir(parents=True)
    cmd, meta = _platform_command(watch_dir)
    swap, named = meta["swap"], meta["named"]
    proc, port, boot_s = await _spawn(cmd[2:], "the bundle's platform")
    row = {"command": " ".join(cmd[2:]), "boot_s": round(boot_s, 3)}
    alone = None
    try:
        if port != swap[named["http"]] or proc.grpc_port != swap[named["grpc"]]:
            raise AssertionError(f"16c: the platform serves REST :{port} gRPC :{proc.grpc_port}, the swapped "
                                 f"ports are {swap}")
        probe_port = swap[named[meta["probe"]["port"]]]
        status, _, body, _ = await _request(probe_port, b"", path=meta["probe"]["path"], method="GET")
        ann = meta["annotations"]
        scrape_port = swap[int(ann["prometheus.io/port"])]
        s_status, _, s_body, _ = await _request(scrape_port, b"", path=ann["prometheus.io/path"], method="GET")
        row.update(readiness=[meta["probe"]["path"], probe_port, status],
                   scrape=[ann["prometheus.io/path"], scrape_port, s_status])
        if status != 200 or s_status != 200 or b"# TYPE" not in s_body:
            raise AssertionError(f"16c: readiness {status} {body[:200]!r}, scrape {s_status} {s_body[:200]!r}")
        cr = _platform_cr("iris")
        status, applied = await _api(swap[named["admin"]], "POST", "", cr)
        if status != 200 or applied["action"] != "created":
            raise AssertionError(f"16c apply iris through the admin port: HTTP {status} {applied}")
        token = await _token(port, "form", cr["spec"]["oauth_key"], cr["spec"]["oauth_secret"])
        alone, *_ = await _start(BASELINE_DIR / "iris.json")
        rng = np.random.default_rng(161)
        for i in range(PLATFORM_REQUESTS):
            x = rng.normal(size=(1 + i, 4)).round(3).tolist()
            got = await _gate_ask(port, token, x)
            want = await _ask_server(alone.port, x)
            _same_bits(f"16c iris request {i}: the bundle's platform against an in-process server", got, want)
        row["iris_requests_bit_for_bit"] = PLATFORM_REQUESTS
    finally:
        if alone is not None:
            await _stop_standalone(alone)
        await _reap(proc)
    print(f"[{card}] 16c the install bundle's platform: {json.dumps(row)}", flush=True)
    return row


def _dockerfile_cmd(path: Path) -> list:
    """The rendered Dockerfile's exec-form CMD."""
    for line in path.read_text().splitlines():
        if line.startswith("CMD "):
            return json.loads(line[len("CMD "):])
    raise AssertionError(f"{path} has no CMD")


async def wrap_bundle(card) -> dict:
    """16d: ``torch_mnist_cnn`` wrapped by ``tools/wrap.py``, the rendered
    Dockerfile's CMD run as a process from the bundle's directory (its
    ``--model-dir`` that directory), driven by ``tools/contract.py``: every
    answer bit for bit the class's answer in this process."""
    import numpy as np

    from seldon_core_tpu_torch.serving.microservice import load_user_object
    from seldon_core_tpu_torch.tools import contract, wrap

    out = Path(wrap.wrap_model(str(ROOT / MNIST_CNN_DIR), "MnistCnn", "0.1", "seldon",
                               out_dir=str(TOOLS_DIR / "wrap_bundle"), force=True))
    cmd = _dockerfile_cmd(out / "Dockerfile")
    if cmd[:3] != ["python", "-m", "seldon_core_tpu_torch.serving.microservice"]:
        raise AssertionError(f"16d: the rendered CMD is {cmd}")
    cmd[cmd.index("--model-dir") + 1] = str(out)
    params = [{"name": "train_steps", "value": "0", "type": "INT"}]
    if DEVICE != "cuda":
        params.append({"name": "device", "value": DEVICE, "type": "STRING"})
    service_port = _free_port()
    proc, port, boot_s = await _spawn(cmd[2:], "the wrapped MnistCnn", cwd=out, env={
        "PYTHONPATH": str(ROOT), "PREDICTIVE_UNIT_SERVICE_PORT": str(service_port),
        "PREDICTIVE_UNIT_PARAMETERS": json.dumps(params)})
    try:
        if port != service_port:
            raise AssertionError(f"16d: the wrapped microservice serves :{port}, not :{service_port}")
        spec = json.loads((out / "contract.json").read_text())
        outs = await asyncio.to_thread(contract.run, spec, "127.0.0.1", port, rounds=WRAP_ROUNDS,
                                       batch_size=CONTRACT_BATCH, seed=16)
    finally:
        await _reap(proc)
    user = load_user_object("MnistCnn", str(out), {"train_steps": 0, **({} if DEVICE == "cuda" else
                                                                         {"device": DEVICE})})
    rng = np.random.default_rng(16)
    for i, got in enumerate(outs):
        _, batch = contract.generate_batch(spec, CONTRACT_BATCH, rng)
        _check_probs(got, CONTRACT_BATCH, 10)
        _same_bits(f"16d batch {i}: the wrapped microservice against the class in-process", _answer(got),
                   np.asarray(user.predict(np.asarray(batch), []), np.float32))
    row = {"cmd": " ".join(cmd[2:]), "boot_s": round(boot_s, 3), "batches_bit_for_bit": len(outs)}
    print(f"[{card}] 16d the wrap bundle: {json.dumps(row)}", flush=True)
    return row


def lint_on_host(card) -> dict:
    """16e: the port's invariant linter on this host exits 0."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.tools.lint"], capture_output=True, text=True,
                       timeout=120, cwd=str(ROOT))
    row = {"exit": r.returncode, "seconds": round(time.perf_counter() - t0, 3),
           "last_line": r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""}
    print(f"[{card}] 16e lint: {json.dumps(row)}", flush=True)
    if r.returncode != 0:
        raise AssertionError(f"16e: the port's linter exits {r.returncode}: {r.stdout[-2000:]} {r.stderr[-500:]}")
    return row


async def serve_soak(card) -> dict:
    """Phase 16a: the soak at full width in this process: the answer check,
    the clean soak, the planted leaks. Returns its numbers; its flash
    launches are the standalone answer's request and the clean soak's load
    window (the two servers' warmups counted apart). ``main``
    runs it in a process of its own (``soak_in_child``)."""
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    gc.unfreeze()  # earlier phases' frozen leftovers go before the readings
    gc.collect()
    LAUNCHES.reset()  # the phase's main path runs from here
    answer = await soak_answer(card)
    clean = await soak_on_card(card, SOAK_SECONDS)
    # ... and ends here: credited are the answer's request and the soak's
    # load window, each a delta around it; the two servers' warmups apart
    launches = answer["launches"] + clean["launches"]
    warmup_launches = LAUNCHES.count - launches
    print(f"[{card}] 16a soak {SOAK_MODEL} clean: {json.dumps(clean)}", flush=True)
    print(f"[{card}] 16a soak preds/s={clean['preds_per_sec']} p99_ms={clean['p99_ms']} "
          f"loop_lag_p99_ms={clean['loop_lag_p99_ms']} rss_slope_net_mb_per_min="
          f"{clean['rss_slope_net_mb_per_min']} (bound {SOAK_RSS_SLOPE_MB_PER_MIN}) device_slope_mb_per_min="
          f"{clean['device_slope_mb_per_min']} (bound {SOAK_DEVICE_SLOPE_MB_PER_MIN})", flush=True)
    layers = answer["layers"]
    if clean["errors"] != 0 or clean["launches"] <= 0 or clean["launches"] % layers:
        raise AssertionError(f"16a soak: {clean['errors']} errors, {clean['launches']} flash launches "
                             f"(want a positive multiple of {layers})")
    over = _soak_limits(clean)
    if any(over.values()):
        raise AssertionError(f"16a soak: a slope over its bound on the clean run: {over} {clean}")
    leak = await soak_on_card(card, SOAK_LEAK_SECONDS, plant=True)
    print(f"[{card}] 16a soak {SOAK_MODEL} with both leaks planted: {json.dumps(leak)}", flush=True)
    caught = _soak_limits(leak)
    if not all(caught.values()):
        raise AssertionError(f"16a soak: the planted leaks pass a slope check: {caught} {leak}")
    return {"answer": answer, "soak": clean, "planted_leaks": {**leak, "caught": caught}, "launches": launches,
            "warmup_launches": warmup_launches}


def soak_main() -> int:
    """``chip_smoke.py --soak``: phase 16a in a fresh process, as the soak
    CLI runs. After the earlier phases this script's C heap holds a large,
    fragmented free pool that absorbs a host leak's first minutes: two full
    runs with 16a in the script's own process read -0.27 and -0.26 MB/min
    of RSS with the host leak planted. Prints the phase's JSON last."""
    import torch

    from seldon_core_tpu_torch.ops import kernel_build

    if not torch.cuda.is_available():
        print("chip_smoke --soak: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)
    kernel_build.build()  # the libraries phase 1 built, found by their sources' hash
    print(json.dumps({"soak_phase": asyncio.run(serve_soak(card_line()))}), flush=True)
    return 0


def tp_soak_main() -> int:
    """``chip_smoke.py --tp-soak``: phase 18d in a process of its own.
    Prints the leg's JSON last."""
    import torch

    from seldon_core_tpu_torch.ops import kernel_build

    if not torch.cuda.is_available():
        print("chip_smoke --tp-soak: no CUDA card", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    kernel_build.build()  # the libraries phase 1 built, found by their sources' hash
    print(json.dumps({"tp_soak": asyncio.run(tp_soak(card_line()))}), flush=True)
    return 0


def tp_soak_in_child(card) -> dict:
    """Phase 18d through ``chip_smoke.py --tp-soak``: its lines printed
    here, its JSON returned."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-soak"], capture_output=True, text=True,
                       timeout=300, cwd=str(ROOT))
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if r.returncode != 0 or not lines:
        raise AssertionError(f"18d: chip_smoke.py --tp-soak exited {r.returncode}: {r.stdout[-2000:]} "
                             f"{r.stderr[-4000:]}")
    return json.loads(lines[-1])["tp_soak"]


def soak_in_child(card) -> dict:
    """Phase 16a through ``chip_smoke.py --soak``: its lines are printed
    here, its JSON returned (the launches it counted in its own process)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--soak"], capture_output=True, text=True,
                       timeout=900, cwd=str(ROOT))
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if r.returncode != 0 or not lines:
        raise AssertionError(f"16a: chip_smoke.py --soak exited {r.returncode}: {r.stdout[-2000:]} {r.stderr[-4000:]}")
    print(f"[{card}] 16a process seconds: {time.perf_counter() - t0:.3f}", flush=True)
    return json.loads(lines[-1])["soak_phase"]


async def legs_and_bundles(card) -> dict:
    """16b on a worker thread while 16c and 16d run: four processes at once."""
    legs = asyncio.get_running_loop().run_in_executor(None, soak_legs, card)
    bundles = await serve_bundles(card)
    return {"soak_legs": await legs, **bundles}


async def serve_bundles(card) -> dict:
    """Phase 16c and 16d: the install bundle's platform and the wrap bundle,
    each run as a process on the card, the two at once."""
    platform, wrapped = await asyncio.gather(bundle_platform(card), wrap_bundle(card))
    return {"bundle_platform": platform, "wrap_bundle": wrapped}


def soak_flash_rows(card, buckets: list) -> dict:
    """Phase 2's check and timing of the flash kernel at the float32,
    non-causal shape the soak served, at every bucket its batches reached,
    as the fused QKV projection's views."""
    import torch

    return {b: check_flash((f"soak_f32_b{b}_views", (b, 12, SOAK_FEATURES, SOAK_FEATURES, 64), torch.float32,
                            False, "qkv_views"), card) for b in buckets}


# ---------------------------------------------------------------- phase 17
MESH_DIR = ROOT / "build" / "mesh"  # git-ignored: the phase's deployment copies, per run
MESH_POSITIONS = 8  # positions of the one card the phase's meshes take
MESH_ROWS = (1, 8, 13, 32)  # rows per request held against the unsharded server (13 pads to bucket 16)
SMALL_ROWS = (1, 8, 13)
MESH_F32_TOL = (2e-4, 2e-5)  # rtol, atol: the JAX tests' float32 tolerance for served BERT
SMALL_MESH_TOL = (2e-5, 2e-6)  # MoE and the pipeline (tests/test_parallel.py)
MESH_LOAD_USERS = (1, 16)


def _mesh_copy(name: str, stem: str, tpu_update: dict | None = None, params_update: dict | None = None) -> Path:
    """A deployment file with its tpu block updated and unit parameters set
    (added where the file has none), under the git-ignored build/mesh/."""
    dep = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    pred = dep["spec"]["predictors"][0]
    pred["tpu"].update(tpu_update or {})
    params = {p["name"]: p for p in pred["graph"]["parameters"]}
    for k, v in (params_update or {}).items():
        if k in params:
            params[k]["value"] = str(v)
        else:
            pred["graph"]["parameters"].append({"name": k, "value": str(v),
                                                "type": "INT" if isinstance(v, int) else "STRING"})
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    path = MESH_DIR / f"{stem}.json"
    path.write_text(json.dumps(dep))
    return path


def _positions(n: int) -> list:
    import torch

    return [torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)] * n


def _position_bytes(runtime) -> list:
    """Each position's parameter bytes (a leaf it shares counted in each)."""
    from seldon_core_tpu_torch.parallel.mesh import unique_tensors

    return [sum(t.numel() * t.element_size() for t in unique_tensors([pp])) for pp in runtime.params]


def hold_mesh(label: str, got, want, dtype_name: str, tol=None) -> dict:
    """Sharded answers against the unsharded server's on the same rows.
    float32: ``tol`` (rtol, atol) and the same argmax. bfloat16: within
    SERVE_ATOL (phase 3's limit), and the same argmax on every row whose
    unsharded margin between its top two classes exceeds SERVE_ATOL (a row
    inside it is a tie at bf16's resolution; counted)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: answers of shape {got.shape} against {want.shape}")
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    flips = got.argmax(axis=1) != want.argmax(axis=1)
    if dtype_name == "float32":
        rtol, atol = tol
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)
        ties = 0
        if flips.any():
            raise AssertionError(f"{label}: argmax differs on {int(flips.sum())} rows")
    else:
        ties = int((margin <= SERVE_ATOL).sum())
        if diff > SERVE_ATOL:
            raise AssertionError(f"{label}: max_abs_diff {diff} > {SERVE_ATOL}")
        if (flips & (margin > SERVE_ATOL)).any():
            raise AssertionError(f"{label}: argmax differs on rows whose margin exceeds {SERVE_ATOL}")
    return {"rows": int(len(got)), "max_abs_diff": diff, "tie_rows": ties, "argmax_flips": int(flips.sum())}


async def _mesh_pair(card, label: str, sharded_path: Path, flat_path: Path, positions: list):
    """The sharded server (over ``positions``) and its unsharded twin, with
    the allocation each added (net of cuBLAS workspaces)."""
    a0 = _allocated() if DEVICE == "cuda" else 0
    sharded, build_s, warm_s = await _start(sharded_path, mesh_devices=positions)
    a1 = _allocated() if DEVICE == "cuda" else 0
    flat, flat_build_s, flat_warm_s = await _start(flat_path)
    a2 = _allocated() if DEVICE == "cuda" else 0
    runtime, ref = _model_runtime(sharded), _model_runtime(flat)
    mesh = runtime.mesh
    if mesh is None or mesh.n_devices != 1 or ref.mesh is not None:
        raise AssertionError(f"{label}: sharded mesh {mesh}, unsharded {ref.mesh}")
    info = {"mesh": mesh.shape, "positions": mesh.size, "cards": _card_count(), "distinct_devices": mesh.n_devices,
            "apply": getattr(runtime.apply_fn, "name", ""), "buckets": list(runtime.buckets),
            "build_s": round(build_s, 3), "warmup_s": round(warm_s, 3),
            "unsharded_build_s": round(flat_build_s, 3), "unsharded_warmup_s": round(flat_warm_s, 3),
            "param_bytes": runtime.param_bytes(), "unsharded_param_bytes": ref.param_bytes(),
            "allocated_bytes": a1 - a0, "unsharded_allocated_bytes": a2 - a1,
            "warmup_reserved_bytes": sharded.warmup_reserved_bytes,
            "unsharded_warmup_reserved_bytes": flat.warmup_reserved_bytes}
    return sharded, flat, info


def _card_count() -> int:
    import torch

    return torch.cuda.device_count() if DEVICE == "cuda" else 0


async def _mesh_load(port: int, seq: int) -> dict:
    """The 1-user p50 and the 16-user predictions/s (one-row requests, one
    LOAD_SECONDS point each)."""
    load = {"payload": "json", "features": seq}
    one = await _load_point(port, MESH_LOAD_USERS[0], load)
    many = await _load_point(port, MESH_LOAD_USERS[1], load)
    return {"p50_ms_1_user": one["p50_ms"], "predictions_per_s_16_users": many["requests_per_sec"]}


def _forward_split(sharded, flat, x) -> dict:
    """One forward of ``x`` (ids on the host, answer read back) on the
    sharded runtime and on the unsharded one: wall ms, and on the card the
    device's busy ms and operations per forward (torch.profiler)."""
    out = {}
    for label, rt in (("sharded", sharded), ("unsharded", flat)):
        kernels, ops = profile_device(lambda rt=rt: rt.predict(x)) if DEVICE == "cuda" else ({}, 0.0)
        out[label] = {"predict_wall_ms": wall_ms(lambda rt=rt: rt.predict(x)),
                      "device_busy_ms": sum(kernels.values()) if kernels else None, "device_ops": ops}
    return out


async def mesh_bert_seq(card) -> dict:
    """17a: bert_seq_parallel.json as the file has it (BERT-base, Ulysses,
    {"data": 2, "seq": 4}, bf16, buckets 8/16/32) on 8 positions of the
    card, a float32 copy, the same with seq_parallel=ring, and a ring copy
    at seq 512 (a 128-token block per position); each answer held against
    the same weights served unsharded on the card."""
    import numpy as np

    rows = {}
    variants = (("ulysses", {}, {}), ("ulysses_f32", {"dtype": "float32"}, {}),
                ("ring", {}, {"seq_parallel": "ring"}), ("ring_seq512", {}, {"seq_parallel": "ring", "seq": 512}))
    for label, tpu_u, par_u in variants:
        path = _mesh_copy("bert_seq_parallel", f"seq_{label}", tpu_u, par_u)
        flat_path = _mesh_copy("bert_seq_parallel", f"seq_{label}_unsharded", {**tpu_u, "mesh": {"data": 1}}, par_u)
        sharded, flat, info = await _mesh_pair(card, f"17a {label}", path, flat_path, _positions(MESH_POSITIONS))
        try:
            runtime, ref = _model_runtime(sharded), _model_runtime(flat)
            want_apply = "bert_ring" if label.startswith("ring") else "bert_ulysses"
            if info["apply"] != want_apply or info["mesh"] != {"data": 2, "seq": 4}:
                raise AssertionError(f"17a {label}: apply {info['apply']} over {info['mesh']}")
            seq, vocab = ref.feature_shape[0], _vocab(ref)
            dtype_name = str(ref.dtype).removeprefix("torch.")
            rng = np.random.default_rng(17)
            got, want = [], []
            for n in MESH_ROWS:
                x = rng.integers(0, vocab, size=(n, seq)).tolist()
                got.append(await _ask_server(sharded.port, x))
                want.append(await _ask_server(flat.port, x))
            held = hold_mesh(f"17a {label}", np.concatenate(got), np.concatenate(want), dtype_name, MESH_F32_TOL)
            keys = (runtime.recompiles_since_warmup(), ref.recompiles_since_warmup())
            if keys != (0, 0):
                raise AssertionError(f"17a {label}: new keys after warmup (sharded, unsharded): {keys}")
            load = {}
            if label == "ulysses":  # the file as it is: its latency and rate beside the unsharded twin's
                load = {"sharded": await _mesh_load(sharded.port, seq), "unsharded": await _mesh_load(flat.port, seq),
                        "bucket_8_forward": _forward_split(runtime, ref, rng.integers(0, vocab, size=(8, seq)))}
        finally:
            await _stop_standalone(sharded)
            await _stop_standalone(flat)
        rows[label] = {**info, "seq": seq, "dtype": dtype_name, **held, "keys_after_warmup": list(keys),
                       **({"load": load} if load else {})}
        print(f"[{card}] 17a bert_seq_parallel {label}: {json.dumps(rows[label])}", flush=True)
    return rows


async def mesh_platform(card) -> dict:
    """17b: moe.json (8 positions) and pipeline_tower.json (4) applied as
    CRs on the port's platform over the card's positions and answered
    through its gateway, each answer held against the same weights served
    unsharded; each position's parameter bytes."""
    import numpy as np

    from seldon_core_tpu_torch.platform import Platform

    rows = {}
    platform = Platform(device=DEVICE, audit_sink_url="mem://", mesh_devices=_positions(MESH_POSITIONS))
    await platform.serve("127.0.0.1", 0, grpc_port=None, fast_ingress=True, admin_port=0)
    try:
        for name in ("moe", "pipeline_tower"):
            cr = json.loads((BASELINE_DIR / f"{name}.json").read_text())
            dep = cr["metadata"]["name"]
            status, body = await _api(platform.admin_port, "POST", "", cr)
            if status != 200 or body["action"] != "created":
                raise AssertionError(f"17b apply {name}: HTTP {status} {body}")
            running = platform.manager.get(dep)
            running.warmup()
            runtime = running.runtimes()[0]
            token = await _token(platform.port, "form", cr["spec"]["oauth_key"], cr["spec"]["oauth_secret"])
            flat, *_ = await _start(_mesh_copy(name, f"{name}_unsharded", {"mesh": {"data": 1}}))
            try:
                rng = np.random.default_rng(17)
                got, want = [], []
                for n in SMALL_ROWS:
                    x = rng.standard_normal((n, runtime.feature_shape[0])).round(4).tolist()
                    got.append(await _gate_ask(platform.port, token, x))
                    want.append(await _ask_server(flat.port, x))
                held = hold_mesh(f"17b {name}", np.concatenate(got), np.concatenate(want), "float32", SMALL_MESH_TOL)
                ref = _model_runtime(flat)
                keys = runtime.recompiles_since_warmup()
            finally:
                await _stop_standalone(flat)
            if keys:
                raise AssertionError(f"17b {name}: {keys} new keys after warmup")
            rows[name] = {"mesh": runtime.mesh.shape, "positions": runtime.mesh.size, "cards": _card_count(),
                          "distinct_devices": runtime.mesh.n_devices, "apply": runtime.apply_fn.name,
                          "position_param_bytes": _position_bytes(runtime), "param_bytes": runtime.param_bytes(),
                          "unsharded_param_bytes": ref.param_bytes(),
                          "resident_bytes": platform.manager.hbm_usage()["deployments"][dep], **held,
                          "keys_after_warmup": keys}
            status, _ = await _api(platform.admin_port, "DELETE", f"/{dep}")
            if status != 200:
                raise AssertionError(f"17b delete {name}: HTTP {status}")
            print(f"[{card}] 17b {name} through the platform: {json.dumps(rows[name])}", flush=True)
    finally:
        await platform.stop()
    return rows


async def mesh_bert_tp(card) -> dict:
    """17c: bert_base_flash.json over tpu.mesh {"model": 4} (Megatron tensor
    parallelism, attn_kernel=pallas, seq 512, bf16): each position's 3
    heads through the flash kernel, held against the unsharded server; the
    kernel at that shape against its plain version."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    path = _mesh_copy("bert_base_flash", "tp_model4", {"mesh": {"model": 4}})
    sharded, flat, info = await _mesh_pair(card, "17c", path, BASELINE_DIR / "bert_base_flash.json",
                                           _positions(MESH_POSITIONS))
    try:
        runtime, ref = _model_runtime(sharded), _model_runtime(flat)
        if info["mesh"] != {"model": 4} or info["apply"] != "bert_tp_pallas":
            raise AssertionError(f"17c: apply {info['apply']} over {info['mesh']}")
        layers, seq, vocab = len(ref.params["layers"]), ref.feature_shape[0], _vocab(ref)
        want_launches = layers * runtime.mesh.size
        rng = np.random.default_rng(170)
        batches = [rng.integers(0, vocab, size=(n, seq)).tolist() for n in (1, 8, 1, 8)]
        got, deltas = [], []
        LAUNCHES.reset()  # the main path's run starts here
        for x in batches:
            before = LAUNCHES.count
            got.append(await _ask_server(sharded.port, x))
            deltas.append(LAUNCHES.count - before)
        launches = LAUNCHES.count  # ... and ends here
        want = [await _ask_server(flat.port, x) for x in batches]
        require_launches("17c bert_base_flash over {'model': 4} flash_attention", deltas, want_launches)
        held = hold_mesh("17c", np.concatenate(got), np.concatenate(want), "bfloat16")
        keys = (runtime.recompiles_since_warmup(), ref.recompiles_since_warmup())
        if keys != (0, 0):
            raise AssertionError(f"17c: new keys after warmup (sharded, unsharded): {keys}")
        heads = runtime.params[0]["layers"][0]["qkv"]["w"].shape[1] // 3 // 64
        split = _forward_split(runtime, ref, rng.integers(0, vocab, size=(8, seq)))
    finally:
        await _stop_standalone(sharded)
        await _stop_standalone(flat)
    kernel_row = check_flash(("bert_tp4_b8_views", (8, heads, seq, seq, 64), torch.bfloat16, False, "qkv_views"),
                             card) if DEVICE == "cuda" else {}
    row = {**info, "layers": layers, "seq": seq, "heads_per_position": heads, "launches_per_forward": deltas,
           "want_per_forward": want_launches, **held, "keys_after_warmup": list(keys), "bucket_8_forward": split}
    print(f"[{card}] 17c bert_base_flash tensor-parallel: {json.dumps(row)}", flush=True)
    return {"row": row, "launches": launches, "kernel": kernel_row}


def mesh_refusals(card) -> dict:
    """17d: the three files without positions asked for, on the one card:
    the server and the platform's manager must each refuse every one by
    the mesh rule."""
    from seldon_core_tpu_torch.operator.reconciler import DeploymentManager
    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    out = {}
    manager = DeploymentManager(device=DEVICE)
    for name in ("bert_seq_parallel", "moe", "pipeline_tower"):
        predictor, dep = load_predictor(str(BASELINE_DIR / f"{name}.json"))
        try:
            PredictorServer(predictor, deployment_name=dep, device=DEVICE)
        except ValueError as e:
            if "devices, have 1" not in str(e):
                raise
            server_says = str(e)
        else:
            raise AssertionError(f"17d: {name} served without positions on one card")
        r = manager.apply(json.loads((BASELINE_DIR / f"{name}.json").read_text()))
        if r.action != "failed" or "devices, have 1" not in r.message:
            raise AssertionError(f"17d: the platform's manager {r.action} {name} without positions: {r.message}")
        out[name] = server_says
    print(f"[{card}] 17d refused without positions: {json.dumps(out)}", flush=True)
    return out


async def serve_mesh(card) -> dict:
    """Phase 17: the serving mesh on the one card (17a, 17b, 17c, 17d)."""
    import shutil

    if MESH_DIR.exists():
        shutil.rmtree(MESH_DIR)
    gc.unfreeze()  # what earlier phases' servers froze and left is freed first
    out = {"cards": _card_count(), "positions": MESH_POSITIONS}
    print(f"[{card}] phase 17: meshes of up to {MESH_POSITIONS} positions on {out['cards']} card(s): "
          "no interconnect is exercised", flush=True)
    t = time.perf_counter()
    out["seq_parallel"] = await mesh_bert_seq(card)
    out["seconds_17a"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["platform"] = await mesh_platform(card)
    out["seconds_17b"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    tp = await mesh_bert_tp(card)
    out["tensor_parallel"], out["launches"], out["kernel"] = tp["row"], tp["launches"], tp["kernel"]
    out["seconds_17c"] = round(time.perf_counter() - t, 3)
    out["refused"] = mesh_refusals(card)
    return out


TP_POSITIONS = 4  # positions of the one card 18b's and 18c's meshes take
TP_REQUESTS = 8  # staggered greedy requests per speculative deployment (18b)
TP_LONG_SEQ = 4096  # 18b's long copy: the draft admission's prefill reaches the causal flash kernel
TP_LONG_NEW = 64
TP_FAULT_BIAS_STD = 0.01  # the planted bias fault's row-parallel biases
TP_FAULT_NEW = 24  # tokens per request of the bias fault's check
TP_INT8_WANT = {"wgmma": 192, "mma": 1, "fma": 0}  # W8A16 launches per int8 BERT-base forward over {"model": 4}
TP_SOAK_SECONDS = 3.0


def _kv_gauge(text: str, tp: int) -> float | None:
    """The per-device KV page gauge's value under the tp label (None when
    the server exports none)."""
    vals = [v for (n, ls), v in metric_samples(text).items()
            if n == "seldon_tpu_decode_kv_pages_per_device" and ("tp", str(tp)) in ls]
    return max(vals) if vals else None


async def tp_tiny(card) -> dict:
    """18a: tiny_gpt_tensor_parallel.json as the file has it ({"tp": 2},
    paged KV with the prefix cache and chunked prefill) over two positions
    of the card: every greedy row held under the tie rule against the same
    deployment at tp 1 and against the fused generate; one SSE stream
    against its buffered reply; no new dispatch key after warmup; the shard
    audit and the allocator check; the per-device page gauge labelled tp 2;
    and, without positions asked for, the JAX package's warn-and-disable
    (one card: "needs 2 devices, have 1", served at tp 1)."""
    import logging

    import numpy as np

    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    path = BASELINE_DIR / "tiny_gpt_tensor_parallel.json"
    one_path = _mesh_copy("tiny_gpt_tensor_parallel", "tp_tiny_tp1", {"decode_mesh_axes": {}})
    srv, build_s, warm_s = await _start(path, mesh_devices=_positions(2))
    ref, *_ = await _start(one_path)
    sched, ref_sched = srv.decode_scheduler, ref.decode_scheduler
    runtime = _model_runtime(srv)
    try:
        if sched.tp != 2 or sched.mesh.size != 2 or ref_sched.tp != 1:
            raise AssertionError(f"18a: tp {sched.tp} over {sched.mesh}, reference tp {ref_sched.tp}")
        dtype_name = str(runtime.dtype).removeprefix("torch.")
        seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
        prompts, budgets = _spec_prompts(sched, vocab, seed=18)
        replies, wall = await _spec_traffic(srv.port, prompts, budgets)
        ref_replies, ref_wall = await _spec_traffic(ref.port, prompts, budgets)
        status, events = await _read_sse(srv.port, prompts[:1])
        _, _, body, _ = await _ids_post(srv.port, prompts[:1])
        buffered = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        keys = (sched.recompiles_since_warmup(), ref_sched.recompiles_since_warmup())
        audit = sched.shard_audit()
        sched.pool.alloc.check()
        gauge = _kv_gauge((await _get(srv.port, "/metrics")).decode(), 2)
        counts = sched.compile_counts()
    finally:
        await _stop_standalone(srv)
        await _stop_standalone(ref)
    label = "18a tiny_gpt_tensor_parallel"
    rows = _served_rows(label, replies, budgets, seq)
    ties = {"tp1": _hold_ids(f"{label} vs tp 1", rows, _served_rows(f"{label} tp1", ref_replies, budgets, seq),
                             runtime.params, seq, dtype_name),
            "fused_generate": _hold_ids(f"{label} vs the fused generate", rows, _fused_oracle(runtime, prompts),
                                        runtime.params, seq, dtype_name)}
    tokens = [e["token"] for e in events if "token" in e]
    if tokens != buffered[seq:].tolist() or events[-1].get("ids") != [buffered.tolist()]:
        raise AssertionError(f"{label}: the SSE stream's tokens {tokens} differ from the buffered reply "
                             f"{buffered[seq:].tolist()}")
    if keys != (0, 0):
        raise AssertionError(f"{label}: new keys after warmup (tp 2, tp 1): {keys}")
    if audit["tp"] != 2 or audit["mesh_devices"] != 2 or audit["components_audited"] < 2:
        raise AssertionError(f"{label}: shard audit {audit}")
    if gauge is None:
        raise AssertionError(f"{label}: no seldon_tpu_decode_kv_pages_per_device sample labelled tp 2")
    # without positions: the host's cards
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("seldon_core_tpu_torch.serving.decode_scheduler")
    logger.addHandler(handler)
    try:
        predictor, name = load_predictor(str(path))
        bare = PredictorServer(predictor, deployment_name=name, device=DEVICE)
    finally:
        logger.removeHandler(handler)
    bare_tp = bare.decode_scheduler.tp
    await bare.decode_scheduler.close()
    warned = [r.getMessage() for r in records if "unservable" in r.getMessage()]
    if _card_count() < 2 and (bare_tp != 1 or not any("needs 2 devices, have 1" in w for w in warned)):
        raise AssertionError(f"{label}: without positions, tp {bare_tp}, warnings {warned}")
    n_tok = sum(budgets)
    row = {"tp": 2, "positions": 2, "dtype": dtype_name, "requests": len(prompts), "tokens": n_tok,
           "ms_per_token": wall * 1e3 / n_tok, "tp1_ms_per_token": ref_wall * 1e3 / n_tok, "tie_rows": ties,
           "sse_tokens": len(tokens), "keys_after_warmup": list(keys), "dispatch_keys": counts, "shard_audit": audit,
           "kv_pages_per_device_gauge": gauge, "build_s": round(build_s, 3), "warmup_s": round(warm_s, 3),
           "without_positions": {"tp": bare_tp, "warning": warned[0] if warned else None}}
    print(f"[{card}] 18a {json.dumps(row)}", flush=True)
    return row


def _round_profile(sched) -> dict:
    """One speculative round with every slot generating at its full limits
    (all-zero block tables: every pool write lands in junk page 0): host
    wall, and on the card the device's busy ms and operations."""
    import numpy as np
    import torch

    n, tree = sched.n_slots, sched.spec_tree
    z, zf = np.zeros(n, np.int32), np.zeros(n, np.float32)
    pos = np.full(n, sched.max_ctx - 1, np.int32)
    bt, limits = sched.pool.block_tables(), np.full(n, sched.spec_k, np.int32)
    wl = None if tree is None else np.tile(np.asarray(tree.branching, np.int32), (n, 1))

    def spec_round():
        sched.pool.load_block_tables(bt)
        sched._spec(z, pos, zf, z, limits, wl, 0)

    with torch.inference_mode(), sched._on_stream():
        row = {"round_wall_ms": wall_ms(spec_round, 3)}
        if DEVICE == "cuda":
            kernels, ops = profile_device(spec_round)
            busy = sum(kernels.values())
            row.update(round_device_ms=busy if busy > 0 else "not measured", device_ops_per_round=ops)
    return row


async def tp_spec_pair(card, label: str, tpu: dict) -> dict:
    """18b, one deployment: gpt2_small_speculative at full width over
    {"tp": 4} and its tp-1 copy, TP_REQUESTS staggered greedy requests on
    each; the tp-4 rows held under the tie rule against the tp-1 rows;
    accept rate, rounds, ms per token and one round's device time and
    operations beside tp 1's; no new key after warmup; the shard audit."""
    tp_path = _mesh_copy("gpt2_small_speculative", f"tp_spec_{label}_tp4", {"decode_mesh_axes": {"tp": 4}, **tpu})
    one_path = _mesh_copy("gpt2_small_speculative", f"tp_spec_{label}_tp1", tpu)
    srv, build_s, warm_s = await _start(tp_path, mesh_devices=_positions(TP_POSITIONS))
    ref, *_ = await _start(one_path)
    sched, ref_sched = srv.decode_scheduler, ref.decode_scheduler
    runtime = _model_runtime(srv)
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    prompts, budgets = _spec_prompts(sched, vocab, seed=180)
    prompts, budgets = prompts[:TP_REQUESTS], budgets[:TP_REQUESTS]
    out = {}
    try:
        if sched.tp != TP_POSITIONS or not sched.spec_enabled:
            raise AssertionError(f"18b {label}: tp {sched.tp}, speculation {sched.spec_enabled}")
        for kind, s in (("tp4", srv), ("tp1", ref)):
            before = _spec_stats(s.decode_scheduler)
            replies, wall = await _spec_traffic(s.port, prompts, budgets)
            after = _spec_stats(s.decode_scheduler)
            out[kind] = (replies, wall, {k: after[k] - before[k] for k in after})
        keys = (sched.recompiles_since_warmup(), ref_sched.recompiles_since_warmup())
        audit = sched.shard_audit()
        sched.pool.alloc.check()
        rounds = {"tp4": _round_profile(sched), "tp1": _round_profile(ref_sched)}
    finally:
        await _stop_standalone(srv)
        await _stop_standalone(ref)
    name = f"18b gpt2_small_speculative {label}"
    rows = _served_rows(name, out["tp4"][0], budgets, seq)
    ties = _hold_ids(f"{name} vs tp 1", rows, _served_rows(f"{name} tp1", out["tp1"][0], budgets, seq),
                     runtime.params, seq, dtype_name)
    if keys != (0, 0):
        raise AssertionError(f"{name}: new keys after warmup (tp 4, tp 1): {keys}")
    if audit["components_audited"] < 4:
        raise AssertionError(f"{name}: shard audit {audit}")
    n_tok = sum(budgets)
    row = {"tp": TP_POSITIONS, "dtype": dtype_name, "tree": tpu.get("decode_spec_tree"), "requests": len(prompts),
           "tokens": n_tok, "tie_rows": ties, "keys_after_warmup": list(keys), "shard_audit": audit,
           "build_s": round(build_s, 3), "warmup_s": round(warm_s, 3)}
    for kind, (_, wall, st) in out.items():
        row[kind] = {"accept_rate": st["accepted"] / max(st["proposed"], 1), "rounds": st["rounds"],
                     "spec_rounds": st["spec_dispatches"], "ms_per_token": wall * 1e3 / n_tok, **rounds[kind]}
    print(f"[{card}] {name}: {json.dumps(row)}", flush=True)
    return row


async def tp_long_admission(card) -> dict:
    """18b, the long prompt: a copy of gpt2_small_speculative over
    {"tp": 4} at seq TP_LONG_SEQ (max_len TP_LONG_SEQ + TP_LONG_NEW, one
    slot, 512-token chunks) with one request: the draft's admission
    prefills the whole prompt, whose causal attention takes the flash
    kernel on each position's 3 heads (2 draft layers x 4 positions = 8
    launches, counted); its ids held under the tie rule against the same
    runtime's scheduler at tp 1."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.decode_scheduler import scheduler_for_executor

    path = _mesh_copy("gpt2_small_speculative", "tp_spec_long_tp4",
                      {"decode_mesh_axes": {"tp": TP_POSITIONS}, "decode_slots": 1, "max_batch": 1,
                       "batch_buckets": [1], "decode_prefill_chunk": 512},
                      {"seq": TP_LONG_SEQ, "max_len": TP_LONG_SEQ + TP_LONG_NEW, "max_new_tokens": TP_LONG_NEW})
    srv, build_s, warm_s = await _start(path, mesh_devices=_positions(TP_POSITIONS))
    sched, runtime = srv.decode_scheduler, _model_runtime(srv)
    draft_layers = len(sched.draft_params["layers"])
    want = draft_layers * TP_POSITIONS
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    vocab = runtime.params["tok_emb"].shape[0]
    prompt = np.random.default_rng(181).integers(0, vocab, size=(1, TP_LONG_SEQ))
    ref = scheduler_for_executor(srv.executor, dataclasses.replace(srv.predictor.tpu, decode_mesh_axes={}))
    ref.graphs.capture = False  # the reference runs eagerly: no capture to pay for
    try:
        LAUNCHES.reset()  # the main path's run starts here
        status, _, body, ms = await _ids_post(srv.port, prompt)
        launches = LAUNCHES.count  # ... and ends here
        if status != 200:
            raise AssertionError(f"18b long prompt returned HTTP {status}: {body[:300]!r}")
        served = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        want_ids = await ref.submit(prompt[0].astype(np.int32))
        keys = sched.recompiles_since_warmup()
    finally:
        await ref.close()
        await _stop_standalone(srv)
    require_launches("18b draft admission at seq 4096 over {'tp': 4} flash_attention", [launches], want)
    ties = tie_rule("18b long prompt vs tp 1", [served], [np.asarray(want_ids, np.int64)], runtime.params,
                    TP_LONG_SEQ, dtype_name)
    if keys:
        raise AssertionError(f"18b long prompt: {keys} new keys after warmup")
    row = {"seq": TP_LONG_SEQ, "draft_layers": draft_layers, "flash_launches": launches, "want": want,
           "latency_ms": ms, "tie_rows": ties, "build_s": round(build_s, 3), "warmup_s": round(warm_s, 3)}
    print(f"[{card}] 18b long prompt: {json.dumps(row)}", flush=True)
    return {"row": row, "launches": launches}


async def tp_bias_fault(card) -> dict:
    """18b's planted fault: the GPT-2-small target with row-parallel biases
    drawn nonzero, decoded eagerly at tp 1, at tp 4, and at tp 4 with each
    position adding the bias to its partial product (summed four times).
    tp 4 must pass the tie rule against tp 1; the planted fault must fail
    it."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.parallel import tp as tp_mod
    from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler
    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, name = load_predictor(str(_mesh_copy("gpt2_small_speculative", "tp_fault", SPEC_OFF)))
    server = PredictorServer(predictor, deployment_name=name, device=DEVICE, cuda_graphs=False)
    await server.decode_scheduler.close()  # only the runtime's weights are used
    runtime = _model_runtime(server)
    rng = np.random.default_rng(182)
    params = dict(runtime.params)
    params["layers"] = [{**lp, **{name: {**lp[name], "b": torch.from_numpy(
        rng.standard_normal(lp[name]["b"].shape).astype(np.float32) * TP_FAULT_BIAS_STD).to(lp[name]["b"])}
        for name in ("attn_out", "mlp_out")}} for lp in runtime.params["layers"]]
    seq, vocab = runtime.generative["seq"], params["tok_emb"].shape[0]
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    prompts = rng.integers(0, vocab, size=(2, seq)).astype(np.int32)

    async def decode(tp: int) -> list:
        kw = {"mesh_axes": {"tp": tp}, "devices": _positions(tp)} if tp > 1 else {}
        s = DecodeScheduler(params, seq_len=seq, max_new_tokens=TP_FAULT_NEW, n_slots=2, dtype=runtime.dtype,
                            cuda_graphs=False, **kw)
        try:
            return [np.asarray(r, np.int64) for r in await asyncio.gather(*(s.submit(p) for p in prompts))]
        finally:
            await s.close()

    one, four = await decode(1), await decode(TP_POSITIONS)
    ties = _hold_ids("18b biased target tp 4 vs tp 1", four, one, params, seq, dtype_name)
    real = tp_mod.row_parallel
    tp_mod.row_parallel = lambda partials, bias, mesh, axis: real([p + bias for p in partials], bias * 0, mesh, axis)
    try:
        planted = await decode(TP_POSITIONS)
    finally:
        tp_mod.row_parallel = real
    must_fail("18b a row-parallel bias added on every position",
              lambda: _hold_ids("18b planted bias", planted, one, params, seq, dtype_name))
    row = {"tie_rows": ties, "planted_rows_differing": sum(int((a != b).any()) for a, b in zip(planted, one))}
    print(f"[{card}] 18b planted bias fault: {json.dumps(row)}", flush=True)
    return row


async def tp_bert_int8(card) -> dict:
    """18c: bert_base_flash.json with weight_quant int8 over tpu.mesh
    {"model": 4}: each position's W8A16 calls on its shards of the int8
    payloads and its 3 heads through the flash kernel; answers within
    SERVE_ATOL (0.015) of the unsharded int8 server's, argmax equal off
    ties; per forward 192 W8A16 launches on the wgmma body plus the head's
    on mma and 48 flash launches, counted; resident bytes and the 1-user
    p50 beside the unsharded server's."""
    import numpy as np

    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    path = _mesh_copy("bert_base_flash", "tp_int8_model4", {"mesh": {"model": TP_POSITIONS}, "weight_quant": "int8"})
    flat_path = _mesh_copy("bert_base_flash", "tp_int8_unsharded", {"weight_quant": "int8"})
    sharded, flat, info = await _mesh_pair(card, "18c", path, flat_path, _positions(TP_POSITIONS))
    try:
        runtime, ref = _model_runtime(sharded), _model_runtime(flat)
        if info["apply"] != "bert_tp_pallas" or runtime.weight_quant != "int8":
            raise AssertionError(f"18c: apply {info['apply']}, weight_quant {runtime.weight_quant!r}")
        layers, seq, vocab = len(ref.params["layers"]), ref.feature_shape[0], _vocab(ref)
        want_flash = layers * TP_POSITIONS
        rng = np.random.default_rng(183)
        batches = [rng.integers(0, vocab, size=(n, seq)).tolist() for n in (1, 8, 8)]
        got, flash_d, int8_d, body_d = [], [], [], []
        LAUNCHES.reset()  # the main path's run starts here
        i8.reset_launches()
        for x in batches:
            f0, q0 = LAUNCHES.count, i8.LAUNCHES.count
            b0 = {b: c.count for b, c in i8.LAUNCHES_BY_BODY.items()}
            got.append(await _ask_server(sharded.port, x))
            flash_d.append(LAUNCHES.count - f0)
            int8_d.append(i8.LAUNCHES.count - q0)
            body_d.append({b: c.count - b0[b] for b, c in i8.LAUNCHES_BY_BODY.items()})
        flash, int8 = LAUNCHES.count, i8.LAUNCHES.count  # ... and ends here
        by_body = {b: c.count for b, c in i8.LAUNCHES_BY_BODY.items()}
        want = [await _ask_server(flat.port, x) for x in batches]
        keys = (runtime.recompiles_since_warmup(), ref.recompiles_since_warmup())
        load = {"payload": "json", "features": seq}
        p50 = {"sharded": (await _load_point(sharded.port, 1, load))["p50_ms"],
               "unsharded": (await _load_point(flat.port, 1, load))["p50_ms"]}
    finally:
        await _stop_standalone(sharded)
        await _stop_standalone(flat)
    require_launches("18c int8 bert_base_flash over {'model': 4} flash_attention", flash_d, want_flash)
    require_launches("18c int8 bert_base_flash over {'model': 4} int8_matmul", int8_d, sum(TP_INT8_WANT.values()))
    if body_d != [TP_INT8_WANT] * len(batches):
        raise AssertionError(f"18c: W8A16 launches per body and request {body_d}, want {TP_INT8_WANT} each")
    held = hold_mesh("18c", np.concatenate(got), np.concatenate(want), "bfloat16")
    if keys != (0, 0):
        raise AssertionError(f"18c: new keys after warmup (sharded, unsharded): {keys}")
    if info["param_bytes"] != info["unsharded_param_bytes"]:
        raise AssertionError(f"18c: int8 resident bytes {info['param_bytes']} over the positions, "
                             f"{info['unsharded_param_bytes']} unsharded")
    row = {**info, "layers": layers, "seq": seq, "flash_per_forward": flash_d, "int8_per_forward": int8_d,
           "int8_by_body_per_forward": body_d, **held, "keys_after_warmup": list(keys), "p50_ms_1_user": p50}
    print(f"[{card}] 18c int8 bert_base_flash over {{'model': 4}}: {json.dumps(row)}", flush=True)
    return {"row": row, "flash": flash, "int8": int8, "int8_by_body": by_body}


async def tp_soak(card) -> dict:
    """18d: a TP_SOAK_SECONDS soak of tensor-parallel decode over two
    positions of the card (``tools/soak.py``'s tp leg): its shard audit and
    allocator check pass, nothing is built after warmup. Run by
    ``chip_smoke.py --tp-soak`` in a process of its own, as the soak CLI
    runs: the soak's stack applies the serving GC policy and leaves its
    server to the process's exit."""
    from seldon_core_tpu_torch.tools.soak import soak

    try:
        out = await soak(duration_s=TP_SOAK_SECONDS, users=4, tp=2, device=DEVICE, mesh_devices=_positions(2))
    finally:
        gc.unfreeze()  # the soak's stack froze the heap
    tp = out["tp"]
    if (tp["tp"], tp["requested_tp"], tp["mesh_devices"]) != (2, 2, 2) or tp["recompiles_after_warmup"] or \
            tp["components_audited"] < 2 or out["errors"]:
        raise AssertionError(f"18d soak --tp 2: {json.dumps(tp)} errors {out['errors']}")
    row = {"seconds": TP_SOAK_SECONDS, "tp": tp, "errors": out["errors"], "paged": out.get("paged"),
           "preds_per_sec": out.get("preds_per_sec")}
    print(f"[{card}] 18d soak --tp 2: {json.dumps(row)}", flush=True)
    return row


async def serve_tp(card) -> dict:
    """Phase 18: tensor-parallel decode and int8 BERT over a "model" axis on
    positions of the one card (18a, 18b, 18c, 18d)."""
    import torch

    gc.unfreeze()
    out = {"cards": _card_count(), "positions": TP_POSITIONS}
    print(f"[{card}] phase 18: decode meshes of up to {TP_POSITIONS} positions on {out['cards']} card(s): "
          "no interconnect is exercised", flush=True)
    t = time.perf_counter()
    out["tiny"] = await tp_tiny(card)
    out["seconds_18a"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["speculative"] = {label: await tp_spec_pair(card, label, tpu)
                          for label, tpu in (("chain", {}), ("tree", {"decode_spec_tree": "2,2,1,1"}))}
    long = await tp_long_admission(card)
    out["long_prompt"] = long["row"]
    out["flash_by_path"] = {"draft admission at seq 4096 over {'tp': 4} (phase 18b)": long["launches"]}
    out["bias_fault"] = await tp_bias_fault(card)
    out["seconds_18b"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    bert = await tp_bert_int8(card)
    out["int8_bert"] = bert["row"]
    out["flash_by_path"]["int8 BERT-base over {'model': 4} (phase 18c)"] = bert["flash"]
    out["launches"] = sum(out["flash_by_path"].values())
    out["int8_launches"], out["int8_by_body"] = bert["int8"], bert["int8_by_body"]
    out["seconds_18c"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["soak"] = tp_soak_in_child(card)
    out["seconds_18d"] = round(time.perf_counter() - t, 3)
    out["kernel"] = check_flash(("tp4_decoder_prefill_views", (1, 3, TP_LONG_SEQ, TP_LONG_SEQ, 64), torch.bfloat16,
                                 True, "qkv_views"), card) if DEVICE == "cuda" else {}
    return out


def sass_counts(library: Path, ops=("HGMMA", "UTMALDG")) -> dict:
    """How many of each instruction in ``ops`` (by default HGMMA, wgmma,
    and UTMALDG, a TMA load) the built library holds, from its
    disassembly."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def host_cost(card, calls: int = 200) -> dict:
    """Host microseconds per call at the bucket-8 shape, fed as QKV views:
    the whole wrapper (checks, ctypes, tensor maps, launch) and PyTorch's
    own attention call beside it. Medians of ``calls`` calls, no
    synchronisation inside the loop."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    q, k, v = qkv_views(8, 12, 512, 64, torch.bfloat16, torch.Generator(device="cuda").manual_seed(5))
    walls, lib_walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        fa.flash_attention(q, k, v)
        walls.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        F.scaled_dot_product_attention(q, k, v)
        lib_walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(wrapper_us=med(walls), library_call_us=med(lib_walls))
    print(f"[{card}] host cost per call (8, 12, 512, 512, 64) views: {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    from seldon_core_tpu_torch.ops import int8_matmul, kernel_build
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES, flash_attention

    # a fatal signal (an abort at the process's exit included) prints every
    # thread's Python stack to stderr
    faulthandler.enable(all_threads=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the deployments' model_store/ and model_dir paths are the checkout's
    os.chdir(ROOT)
    card = card_line()
    print(card, flush=True)
    print(f"[{card}] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build_s = kernel_build.build()
    print(f"[{card}] build: {json.dumps(build_s)} total_s={time.perf_counter() - t0:.3f}", flush=True)
    for name, log in kernel_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Potential Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    sass = sass_counts(kernel_build.library_path("flash_attention"))
    print(f"[{card}] flash_attention SASS: {json.dumps(sass)}", flush=True)
    if min(sass.values()) == 0:
        raise AssertionError(f"the flash kernel's library lacks wgmma or TMA instructions: {sass}")
    int8_sass = sass_counts(kernel_build.library_path("int8_matmul"), ("HGMMA", "UTMALDG", "HMMA"))
    print(f"[{card}] int8_matmul SASS: {json.dumps(int8_sass)}", flush=True)
    if min(int8_sass.values()) == 0:
        raise AssertionError(f"the int8_matmul library lacks wgmma, TMA or mma.sync instructions: {int8_sass}")
    print(f"[{card}] phase 1 seconds: {time.perf_counter() - t0:.3f}", flush=True)

    # 2. kernel against its plain version
    t2 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    dense, views = "contiguous", "qkv_views"
    cases = [
        ("bert_base_b8", (8, 12, 512, 512, 64), bf16, False, dense),
        ("bert_base_b8_views", (8, 12, 512, 512, 64), bf16, False, views),
        ("bert_base_b1", (1, 12, 512, 512, 64), bf16, False, dense),
        ("bert_base_b1_views", (1, 12, 512, 512, 64), bf16, False, views),
        ("auto_long", (1, 12, 4096, 4096, 64), bf16, False, dense),
        ("auto_long_views", (1, 12, 4096, 4096, 64), bf16, False, views),
        ("causal_d128", (1, 12, 2048, 2048, 128), bf16, True, dense),
        ("ragged_causal_d128", (2, 3, 200, 256, 128), bf16, True, dense),
        ("ragged_d128", (2, 3, 65, 48, 128), bf16, False, dense),
        ("f32_qpad", (2, 3, 40, 64, 64), f32, False, dense),
        ("f32_qpad_causal", (2, 3, 40, 64, 64), f32, True, dense),
        # the DAG's BERT-base arms at seq 128: one 128-key tile
        ("dag_seq128_b1", (1, 12, 128, 128, 64), bf16, False, dense),
        ("dag_seq128_b1_views", (1, 12, 128, 128, 64), bf16, False, views),
        ("dag_seq128_b64", (64, 12, 128, 128, 64), bf16, False, dense),
        ("dag_seq128_b64_views", (64, 12, 128, 128, 64), bf16, False, views),
        # the decoder's prefill at GPT-2-small widths and a 4096-token prompt
        ("decoder_prefill_views", (1, 12, 4096, 4096, 64), bf16, True, views),
        ("decoder_prefill", (1, 12, 4096, 4096, 64), bf16, True, dense),
        ("decoder_prefill_f32", (1, 12, 4096, 4096, 64), f32, True, views),
    ]
    rows = {c[0]: check_flash(c, card) for c in cases}
    host = host_cost(card)
    x = torch.zeros(1, 12, 4100, 64, device="cuda", dtype=bf16)
    try:
        flash_attention(x, x, x)
    except ValueError as e:
        print(f"[{card}] ragged kv 4100 rejected: {e}", flush=True)
    else:
        raise AssertionError("flash_attention took a ragged kv length of 4100")
    del x
    print(f"[{card}] phase 2 seconds: {time.perf_counter() - t2:.3f}", flush=True)

    # 3. BERT-base at seq 512
    t3 = time.perf_counter()
    bert_launches = asyncio.run(serve_bert(card, BASELINE_DIR / "bert_base_flash.json"))
    if bert_launches <= 0:
        raise AssertionError("the BERT path launched no flash_attention kernel")
    twins = {"bert_base_flash": asyncio.run(serve_twins(card, BASELINE_DIR / "bert_base_flash.json",
                                                        ("flash_attention",)))}
    print(f"[{card}] phase 3 seconds: {time.perf_counter() - t3:.3f}", flush=True)

    # 4. the five BASELINE deployments
    t4 = time.perf_counter()
    asyncio.run(serve_small(card))
    asyncio.run(serve_engine_compat(card))
    serve_resnet_ensemble(card)
    dag_launches = asyncio.run(serve_dag(card))
    if dag_launches <= 0:
        raise AssertionError("the DAG path launched no flash_attention kernel")
    twins.update(asyncio.run(baseline_twins(card)))
    print(f"[{card}] phase 4 seconds: {time.perf_counter() - t4:.3f}", flush=True)

    # 5. the four decoder deployments
    t5 = time.perf_counter()
    asyncio.run(serve_tiny_gpt(card))
    asyncio.run(serve_continuous_batching(card))
    asyncio.run(serve_paged_kv(card))
    decoder_launches = asyncio.run(serve_long_prompt(card))
    if decoder_launches <= 0:
        raise AssertionError("the decoder path launched no flash_attention kernel")
    twins["gpt2_small_long_prompt"] = asyncio.run(serve_twins(card, BASELINE_DIR / "gpt2_small_long_prompt.json",
                                                              ("flash_attention",)))
    print(f"[{card}] phase 5 seconds: {time.perf_counter() - t5:.3f}", flush=True)

    # 6. speculative decoding: the three speculative deployments
    t6 = time.perf_counter()
    before = LAUNCHES.count
    asyncio.run(serve_speculation(card))
    # the speculation path's attention is masked attention over the page
    # pool and the draft cache, plain PyTorch as in the JAX package
    spec_launches = LAUNCHES.count - before
    print(f"[{card}] phase 6 flash_attention launches: {spec_launches}", flush=True)
    print(f"[{card}] phase 6 seconds: {time.perf_counter() - t6:.3f}", flush=True)

    # 7. int8 weights and the resilience layer
    t7 = time.perf_counter()
    int8_rows = int8_kernel_checks(card)
    int8_host = int8_host_cost(card)
    int8_launches, int8_by_body = asyncio.run(serve_bert_int8(card))
    if int8_launches <= 0:
        raise AssertionError("the bert_int8 path launched no int8_matmul kernel")
    twins["bert_int8"] = asyncio.run(serve_twins(card, BASELINE_DIR / "bert_int8.json", ("int8_matmul",),
                                                 {"payload": "json", "features": 128}))
    asyncio.run(serve_resilience(card))
    print(f"[{card}] phase 7 seconds: {time.perf_counter() - t7:.3f}", flush=True)

    # 8. telemetry: traces, /metrics, the flight recorder and the profiler
    t8 = time.perf_counter()
    telemetry_out = asyncio.run(serve_telemetry(card))
    print(f"[{card}] phase 8 seconds: {time.perf_counter() - t8:.3f}", flush=True)

    # 9. the pipelined rounds against the serial loop, and the KV tiers
    t9 = time.perf_counter()
    before = LAUNCHES.count
    phase9 = asyncio.run(serve_phase9(card))
    # prompts of 32 and 128 tokens: the decode programs' attention is the
    # masked attention over the page pool, plain PyTorch as in the JAX package
    pipeline_launches = LAUNCHES.count - before
    print(f"[{card}] phase 9 flash_attention launches: {pipeline_launches}", flush=True)
    print(f"[{card}] phase 9 seconds: {time.perf_counter() - t9:.3f}", flush=True)

    # 10. learning: fine-tuning from feedback, distillation, the head served
    t10 = time.perf_counter()
    before, int8_before = LAUNCHES.count, int8_matmul.LAUNCHES.count
    learning = asyncio.run(serve_learning(card))
    # no gradient passes through a kernel: the wrappers refuse autograd, and
    # the learning paths' attention is dense (under FLASH_MIN_SEQ)
    learning_launches = LAUNCHES.count - before
    learning_int8 = int8_matmul.LAUNCHES.count - int8_before
    print(f"[{card}] phase 10 flash_attention launches: {learning_launches} int8_matmul launches: {learning_int8}",
          flush=True)
    print(f"[{card}] phase 10 seconds: {time.perf_counter() - t10:.3f}", flush=True)

    # 11. model sources and user code: hf-bert://, file://, SHADOW,
    # OUTLIER_DETECTOR and PYTHON_CLASS
    t11 = time.perf_counter()
    store = write_model_store(card)
    sources = asyncio.run(serve_model_sources(card))
    user_code = asyncio.run(serve_user_code(card))
    source_launches = sources["bert_base_hf"] + sources["bert_base_file"]
    source_int8 = sources["bert_base_hf_int8"]
    print(f"[{card}] phase 11 flash_attention launches: {source_launches} (bert_base_hf {sources['bert_base_hf']}, "
          f"bert_base_file {sources['bert_base_file']}) int8_matmul launches: {source_int8} by body "
          f"{json.dumps(sources['bert_base_hf_int8_by_body'])}", flush=True)
    print(f"[{card}] phase 11 seconds: {time.perf_counter() - t11:.3f}", flush=True)

    # 12. the replicated decode fleet: routing, eviction and migration,
    # drain, warm scale-up
    t12 = time.perf_counter()
    fleet = asyncio.run(serve_fleet(card))
    print(f"[{card}] phase 12 seconds: {time.perf_counter() - t12:.3f}", flush=True)

    # 13. the split data plane: the OAuth gateway, remote REST units, the
    # standalone microservice
    t13 = time.perf_counter()
    split_plane = asyncio.run(serve_split_data_plane(card))
    split_launches = split_plane["launches"]["flash_attention"]
    if split_launches <= 0:
        raise AssertionError("the split data plane's paths launched no flash_attention kernel")
    print(f"[{card}] phase 13 flash_attention launches: {split_launches} int8_matmul launches: "
          f"{split_plane['launches']['int8_matmul']}", flush=True)
    print(f"[{card}] phase 13 seconds: {time.perf_counter() - t13:.3f}", flush=True)

    # 14. gRPC: the predictor's gRPC port, the gateway over gRPC and
    # gRPC-Web, the split DAG over gRPC, the container contract over gRPC
    t14 = time.perf_counter()
    grpc_plane = asyncio.run(serve_grpc(card))
    grpc_launches = grpc_plane["launches"]["flash_attention"]
    if grpc_launches <= 0:
        raise AssertionError("the gRPC paths launched no flash_attention kernel")
    print(f"[{card}] phase 14 flash_attention launches: {grpc_launches} int8_matmul launches: "
          f"{grpc_plane['launches']['int8_matmul']}", flush=True)
    print(f"[{card}] phase 14 seconds: {time.perf_counter() - t14:.3f}", flush=True)

    # 15. the all-in-one platform: the operator API, admission, hot updates,
    # the directory watcher, the profiler endpoints, the native codec
    t15 = time.perf_counter()
    platform_out = asyncio.run(serve_platform(card))
    platform_flash, platform_int8 = (platform_out["launches"]["flash_attention"],
                                     platform_out["launches"]["int8_matmul"])
    twins_flash, twins_int8 = (platform_out["standalone_launches"]["flash_attention"],
                               platform_out["standalone_launches"]["int8_matmul"])
    if platform_flash <= 0 or platform_int8 <= 0:
        raise AssertionError(f"the platform's paths launched flash {platform_flash}, int8_matmul {platform_int8} times")
    print(f"[{card}] phase 15 flash_attention launches: platform {platform_flash} standalone twins {twins_flash}; "
          f"int8_matmul launches: platform {platform_int8} standalone twins {twins_int8}; int8 by body, both "
          f"{json.dumps(platform_out['launches']['int8_by_body_with_standalone'])}", flush=True)
    print(f"[{card}] phase 15 seconds: {time.perf_counter() - t15:.3f}", flush=True)

    # 16. the tools: the soak at full width, its generative legs, the install
    # bundle's platform, the wrap bundle, the linter
    t16 = time.perf_counter()
    tools_out = soak_in_child(card)
    tools_flash = tools_out["launches"]
    if tools_flash <= 0:
        raise AssertionError("the soak launched no flash_attention kernel")
    tools_out.update(asyncio.run(legs_and_bundles(card)))
    tools_out["lint"] = lint_on_host(card)
    soak_rows = soak_flash_rows(card, sorted(int(b) for b in tools_out["soak"]["buckets_reached"]))
    print(f"[{card}] phase 16 flash_attention launches: {tools_flash}, warmups apart "
          f"{tools_out['warmup_launches']} (buckets reached "
          f"{json.dumps(tools_out['soak']['buckets_reached'])})", flush=True)
    print(f"[{card}] phase 16 seconds: {time.perf_counter() - t16:.3f}", flush=True)

    # 17. the serving mesh on positions of the one card: sequence, expert,
    # pipeline and tensor parallelism, and the refusals without positions
    t17 = time.perf_counter()
    mesh_out = asyncio.run(serve_mesh(card))
    mesh_flash = mesh_out["launches"]
    if mesh_flash <= 0:
        raise AssertionError("the tensor-parallel BERT path launched no flash_attention kernel")
    print(f"[{card}] phase 17 flash_attention launches: {mesh_flash} (17c, "
          f"{mesh_out['tensor_parallel']['want_per_forward']} a forward)", flush=True)
    print(f"[{card}] phase 17 seconds: {time.perf_counter() - t17:.3f}", flush=True)

    # 18. tensor-parallel decode and int8 BERT over a "model" axis on
    # positions of the one card
    t18 = time.perf_counter()
    tp_out = asyncio.run(serve_tp(card))
    tp_flash, tp_int8 = tp_out["launches"], tp_out["int8_launches"]
    if min(tp_out["flash_by_path"].values()) <= 0 or tp_int8 <= 0:
        raise AssertionError(f"phase 18 launched flash {tp_out['flash_by_path']}, int8_matmul {tp_int8} times")
    print(f"[{card}] phase 18 flash_attention launches: {tp_flash} {json.dumps(tp_out['flash_by_path'])}; "
          f"int8_matmul launches: {tp_int8} by body {json.dumps(tp_out['int8_by_body'])}", flush=True)
    print(f"[{card}] phase 18 seconds: {time.perf_counter() - t18:.3f}", flush=True)

    main = rows["bert_base_b8_views"]  # the layout the served forward hands the kernel
    dag = rows["dag_seq128_b64_views"]
    prefill_row = rows["decoder_prefill_views"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/pallas_flash.py:147",
        "launches": bert_launches + dag_launches + decoder_launches + spec_launches + pipeline_launches
        + learning_launches + source_launches + split_launches + grpc_launches + platform_flash + twins_flash
        + tools_flash + mesh_flash + tp_flash,
        "launches_by_path": {"bert_base_flash (phase 3)": bert_launches, "full_dag_bert (phase 4)": dag_launches,
                             "gpt2_small_long_prompt (phase 5)": decoder_launches,
                             "speculative deployments (phase 6)": spec_launches,
                             "pipelined and tier deployments (phase 9)": pipeline_launches,
                             "learning (phase 10)": learning_launches,
                             "model sources (phase 11)": source_launches,
                             "replicated fleet (phase 12)": fleet["launches"]["flash_attention"],
                             "split data plane (phase 13)": split_launches,
                             "gRPC (phase 14)": grpc_launches,
                             "platform (phase 15)": platform_flash,
                             "platform's standalone twins (phase 15)": twins_flash,
                             "soak (phase 16, its own process)": tools_flash,
                             "tensor-parallel BERT-base over {'model': 4} (phase 17c)": mesh_flash,
                             **tp_out["flash_by_path"]},
        "warmup_launches_apart": {"soak's two servers (phase 16)": tools_out["warmup_launches"]},
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "ms_cold_l2": main["ms_cold_l2"],
        "host_us": host["wrapper_us"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "seq128_b64_views": {k: dag[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")},
        "decoder_prefill_views": {k: prefill_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms")},
        # float32, non-causal, at the batch buckets the phase-16 soak reached
        "soak_f32_views": {f"b{b}": {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                        "library_ms")} for b, row in soak_rows.items()},
        # one model-axis position's 3 heads of BERT-base, bf16 (phase 17c)
        "tp4_b8_views": {k: mesh_out["kernel"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                             "library_ms")},
        # one decode-mesh position's 3 heads of the draft's causal prefill at
        # seq 4096, bf16 (phase 18b)
        "tp4_decoder_prefill_views": {k: tp_out["kernel"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                                       "bound_by", "library_ms")},
    }]
    int8_main = int8_rows["qkv_b32_bfloat16"]  # the served shape with the most work
    served = {"attn_out_b32_bfloat16", "mlp_in_b32_bfloat16", "mlp_out_b32_bfloat16", "head_b32_bfloat16",
              "pooler_b32_bfloat16",
              "qkv_b1_bfloat16", "qkv_b32_float32", "stacked_e3_shared_x_bfloat16", "stacked_e3_bfloat16",
              "stacked_e3_k776_shared_x_bfloat16", "stacked_e3_k776_bfloat16",
              "m_ragged_bfloat16", "k_ragged_bfloat16", "n_ragged_bfloat16",
              "tp4_qkv_b8_bfloat16", "tp4_attn_out_b8_bfloat16", "tp4_mlp_in_b8_bfloat16", "tp4_mlp_out_b8_bfloat16"}
    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/csrc/int8_matmul.cu",
        # no Pallas kernel: XLA's fusion of quant.dequantize into the matmul
        "replaces": "seldon_core_tpu/models/base.py:137",
        "launches": int8_launches + learning_int8 + source_int8 + platform_int8 + twins_int8 + tp_int8,
        "launches_by_path": {"bert_int8 (phase 7)": int8_launches, "learning (phase 10)": learning_int8,
                             "model sources (phase 11)": source_int8,
                             "replicated fleet (phase 12)": fleet["launches"]["int8_matmul"],
                             "split data plane (phase 13)": split_plane["launches"]["int8_matmul"],
                             "gRPC (phase 14)": grpc_plane["launches"]["int8_matmul"],
                             "platform (phase 15)": platform_int8,
                             "platform's standalone twins (phase 15)": twins_int8,
                             "int8 BERT-base over {'model': 4} (phase 18c)": tp_int8},
        "launches_by_body": int8_by_body,
        "host_us": int8_host["wrapper_us"],
        **{k: int8_main[k] for k in ("max_abs_err", "ms", "ms_mma", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        **{name: {k: int8_rows[name][k] for k in ("body", "max_abs_err", "ms", "ms_mma", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")} for name in sorted(served)},
    })
    print(json.dumps({"captured_vs_eager": {name: {k: v for k, v in t.items() if k != "breakdown"}
                                            for name, t in twins.items()}}), flush=True)
    print(json.dumps({"telemetry": {"card": card, **telemetry_out}}), flush=True)
    print(json.dumps({"pipeline_and_tiers": {"card": card, **phase9}}), flush=True)
    print(json.dumps({"learning": {"card": card, **learning}}), flush=True)
    print(json.dumps({"model_sources_and_user_code": {"card": card, "store": store, **{
        k: v for k, v in sources.items() if not k.endswith("_by_body")}, **user_code}}), flush=True)
    print(json.dumps({"fleet": {"card": card, **fleet}}), flush=True)
    print(json.dumps({"split_data_plane": {"card": card, **split_plane}}), flush=True)
    print(json.dumps({"grpc": {"card": card, **grpc_plane}}), flush=True)
    print(json.dumps({"platform": {"card": card, **platform_out}}), flush=True)
    print(json.dumps({"tools": {"card": card, **tools_out}}), flush=True)
    print(json.dumps({"mesh": {"card": card, **{k: v for k, v in mesh_out.items() if k != "kernel"}}}), flush=True)
    print(json.dumps({"tensor_parallel_decode": {"card": card, **{k: v for k, v in tp_out.items() if k != "kernel"}}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--soak"]:
        sys.exit(soak_main())
    if sys.argv[1:2] == ["--grpc-load"]:
        sys.exit(grpc_load_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-soak"]:
        sys.exit(tp_soak_main())
    sys.exit(main())
