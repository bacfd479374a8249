#!/usr/bin/env python3
"""On-card smoke test of celestia_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--xor-table-out PATH] [--crossover-out PATH] [--sass-out PATH]
    python3 chip_smoke.py --mesh-only

``--mesh-only`` builds the kernels and runs phase 6i alone: on a machine of
several cards (four, joined by NVLink) its meshes over distinct cards are the
cross-card reading, without the single-card phases; it prints no ``ok`` line.
``--xor-table-out`` also writes the dense/XOR routing table this run measured
(phase 7) to PATH, in the format of celestia_tpu_torch/config/xor_schedule.json;
``--crossover-out`` writes the App's gpu/native backend table (phase 6f) to
PATH, in the format of celestia_tpu_torch/config/crossover.json;
``--sass-out`` writes the SASS of K2, K3 and the tree kernel to PATH.

The port has four extend routes (fused/unfused × dense/XOR); a route is
picked with the env pins CELESTIA_FUSED_KERNELS and CELESTIA_XOR_SCHEDULE,
as a user picks it. Seven kernels carry them: K1 encode2d_hash, K2
leaf_digests2d, K3 sha256_words, K4 encode2d, K5 encode2d_xor_hash, K6
encode2d_xor, and nmt_tree, K3's tree form (every route ends in it: the
leaf-digest grid to the row and column roots, and the row levels, in one
launch). dah_merkle, K3's merkle form (csrc/dah_merkle.cu), is the device
DAH of extend_and_root_device: one launch over the 4k axis roots. K3
itself is on no entry's path any more. decode_sweep (csrc/rs_decode.cu)
carries EDS repair: one launch per planned sweep of the Leopard erasure
decode, in place in the EDS. ragged_gather (csrc/ragged_gather.cu) carries
the serving reads: one launch per page geometry of a crowd of DAS samples
across heights, reading every row in place through the paged cache's pages, and
assemble_square (csrc/assemble_square.cu) the proposer's square: one
launch builds it on the card from the resident blob arena and the
deduplicated host shares.

Phases, in order (any failed check raises, so the script exits non-zero and
prints no result; it also exits non-zero when no CUDA device is present):

1. Environment: versions, the card's name, power limit, SM count and
   maximum SM clock, the CRC-32C the host runs (``google_crc32c`` or
   ``numpy``: the store's checksums), the kernel build (nvcc for sm_90a, from
   celestia_tpu_torch/csrc/) and its seconds, the ptxas report (registers,
   spills; also of K5/K6, every decode sweep instance and the merkle
   kernel) and SASS opcode mix of the k = 128 encode, K2, K3, the tree
   kernel, the merkle kernel and the n = 256 decode sweep (and its LDS,
   PRMT, LOP3 and SHF in one pass of its work-item loop), the tree
   kernel's resident blocks per SM, the operations of one
   SHA-256 block counted from K3's compiled block loop (ALU pipe: LOP3,
   SHF, IADD3, PRMT; FMA pipe: IMAD), which every SHA bound below uses, the
   operations of its 64 rounds alone counted from the tree kernel's
   rounds-only loop (the chain term of the SHA tree bounds), the XOR
   schedule's host compile at k = 128 and its seconds, and K5/K6's layout
   at each rung of the routing table (``xor_layout``: block groups, cluster
   size, row segments, step pairs in registers, shared memory per block,
   the padding of the conflict-free operand order).
2. Each kernel against its plain PyTorch version on the card, byte for byte:
   K3 on messages of every length 0..600 (and against hashlib) and at the
   NMT level shapes; the merkle kernel at every power of two k from 1 to
   128, one DAH and a batch of 3 (and against hashlib); K1, K4, K5 and K6
   at every power of two k from 1 to
   128 (the FFT program of K1/K4 differs per k), K2 at the same k on both
   of its main-path shapes, (k, k·512) and (2k, 2k·512), and at 1, 3 and
   65 rows; the FFT and XOR kernels against each other (K5 = K1,
   K6 = K4); and the tree kernel at every power of two k from 1 to 128
   (roots of both families, and the row roots with the full row-level
   stack) on random digests, under random, TAIL_PADDING-tailed and single
   namespaces, its digest tiles in the fused route's layout. Then K1 and K4
   in the strided layouts of the main path at every k (``strided_vs_plain``:
   the three quadrant encodes in place in one EDS, and the roots-only
   core's scratch layout), and K2 reading each Q0 cell's namespace from the
   cell itself.
3. The reference DAH hashes (MIN k = 1, TYPICAL k = 2, MAX k = 128) through
   da.extend_shares -> new_data_availability_header(...).hash(), and the DAH
   computed on the device by extend_and_root_device equal to the host's, on
   each of the four routes.
4. Realistic squares (sorted v0 namespaces over random bytes, and a variant
   with a TAIL_PADDING tail) at k = 64 and k = 128. For each route the
   launch counts are set to 0 just before the main path runs on the k = 128
   square (extend -> DAH -> row levels, as a block producer runs it) and
   read just after: the route's own kernels ran, the tree kernel once per
   extend and once for the row levels, K3 no time, and the other routes'
   encode kernels did not. The device-DAH entry (extend_and_root_device)
   is read the same way: the merkle kernel once, the tree kernel once, K3
   no time (its ``main_path`` line comes with phase 7's timing: the
   device DAH's aten ops and H2D copies, 0 each, and the entry's wall ms
   at k = 64 and 128). On
   each route the kernel route equals the plain route
   (EDS, roots, DAH) and the fused dense route; on the fused dense route the
   row levels equal the plain ones, and at k = 64 the roots equal the host
   oracle (gf256 + nmt_host).
5. The block path around the kernels: ``roots_only`` (on every route,
   roots_device's roots-only core equals extend_roots_device_resident's
   roots and the plain route, k = 64 and 128); ``batched``
   (batched_roots_device on lists and stacked arrays, B = 1, 2, 4, 8 at
   k = 64 and 128, byte-identical to one roots_device a square, with ms per
   square); ``staging`` (the k = 128 square to the card through
   device_put_chunked with 1, 2, 4 and 8 chunks, against a pageable and a
   pinned ``.to()``, host time until the card has it, bytes equal) and
   ``staging_levers`` (fused dense roots_device at k = 128, in turns, with
   the chunk rule, with one chunk, and with a pageable ``.to()`` instead);
   ``integrity`` (the syndrome through K4 against its plain version at
   sampled and full, clean and with a flipped bit, with its device ms) and
   ``integrity_drill`` (a device.extend.output bitflip raising with the
   plain count, a transfer.chunk bitflip healing and raising);
   ``sliced_reads`` (row, column, cell and batch reads of the resident
   k = 128 EDS equal to a chunked full fetch, with the bytes each moved).
6. EDS repair (``repair``): first the decode sweep at every power of two
   k from 1 to 32, every sweep of one random 25% mask against its plain
   version; then the repair-after-extend path of a catching-up
   node, at k = 128 and 64: bench.py's square extended by
   extend_roots_device_resident, erased under bench.py's four masks
   (seeds 7-10, 25%, one row sweep each) and tests/test_repair.py's
   multi-sweep mask (a full row, a full column and a corner: a row and a
   column sweep). Every sweep of every mask: the kernel byte-identical to
   its plain version (the bit-matrix spelling) on the same staged input.
   The main path with the counts from 0: repair_resident_verified under
   every mask (one decode launch per planned sweep, one K2 and one tree
   launch per verify, nothing else) and repair_device (the sweeps alone);
   both return the true EDS, a flipped row or column root raises, the
   caller's resident EDS is unchanged and run() gives the same bytes
   twice. Host ms of plan_sweeps, wall ms of repair_device and of the
   resident cycle (plan, sweeps, root recompute, root compare), median of
   10, the masks in turn; at k = 128 the same two entries with the plan's
   error-locator product through torch (the port) and through numpy's
   BLAS (``repair_levers``: blocks of 2 warm-up and 5 timed calls, the
   spellings in turns, twice), and a device.repair.output bitflip
   under the full audit raises IntegrityError at that site.
6b. Serving reads (``serving``): the ragged gather against its plain
   version byte for byte at every power of two k from 1 to 128 (one
   descriptor, a group with duplicates, 300 descriptors at k = 128), over
   more descriptors and pages than one launch's parameter table holds (one
   launch a table), and over four page geometries in one group (one launch
   each). Then a node (``Node``) with its default paged cache (128 MiB,
   4 heights, 8-row pages) holding four heights of bench.py's square at
   k = 128 (seeds 42-45, extended by da.extend_shares and put as ExtendBlock
   retention puts them): a crowd of 256 samples uniform over the heights
   through sample_batch_ragged, with the counts from 0 (ragged_gather once,
   nothing else), every document equal to the host's from the fetched EDS
   and verified against block_dah(h); ms per sample (median of 5 fresh
   crowds) and the stage split of one, and sample_batch at one height (64
   samples). The same squares and crowd at a budget of 8 pages: the same
   documents, demotions and fault-ins, the device bytes back inside the
   budget and one page after each call, each square's memory freed when its
   handle is dropped (the pages are buffers of their own), ms per sample,
   and one page's demotion, fault-in and CRC32C ms; a cache.faultin bitflip
   drill healing the one height it names; and a ResidentEdsCache node whose
   provers come from one K2 and one tree launch, its proofs the host's.
6c. The proposer's path from transactions (``proposal``): the square
   assembly kernel against its plain version byte for byte at every power
   of two k from 1 to 128 on seven input families (one blob; many blobs of
   random share counts and odd lengths; host cells over blob cells; cells
   no blob or host row covers; no blob; blobs running past the arena's
   end; the arena's alignments: every shift between a share's arena bytes
   and its cell on first and later shares, last shares ending at every
   residue mod 16, and an arena of 7 mod 16 bytes with a blob on its last
   byte), 56 cases, with its registers and spills (none allowed). Then
   bench.py config 8b's traffic
   (60 blobs of 120,000 random bytes, seed 11, each in its own v0
   namespace, a fixed inner tx of a signed PFB's length): the port's
   square.build_ex to a k = 128 square, the blobs staged by put_many into
   a fresh DeviceBlobArena (median of 5), and assembled_proposal_dah with
   the counts from 0 (assemble_square 1, K2 1, K1 3, the tree 1, nothing
   else; the bytes counted at proposal.stage and at arena.stage), its DAH
   equal to roots_device's and to the host NMT DAH of the same square, and
   the MIN/TYPICAL/MAX DAHs through assembled_roots with every cell a host
   cell; host ms of the blob content keys and of the proposal's metadata,
   and the medians of 20 of assembled_proposal_dah and of roots_device on
   the same square, in turns.
6d. The durable store tier (``store``), in a fresh temporary directory
   removed at the end: a node with a home (``Node(home=...)``) holding
   phase 6b's four k = 128 heights persists each through
   _persist_block_eds with the counts from 0 (K2 once and nmt_tree once,
   the row levels; the square fetched once at store.persist), each entry
   with its levels, its stored DAH equal to block_dah's bytes and to the
   extend's roots; ms per height split into fetch (d2h), levels, CRC and
   write (with the fsyncs), and the file size. The same node's crowd gives
   phase 6b's documents. Then a fresh node over the same home (a deep
   re-index of 4 heights, its ms) serves the crowd from disk: ragged_gather
   once and nothing else (every height's provers from the stored levels),
   the documents and DAH bytes equal to those before the restart, pages read
   off disk, ragged_gather equal to its plain version on the store-loaded
   pages; cold and warm ms per sample beside phase 6b's, the cold crowd's
   stage split (disk, crc, h2d, gather, d2h, device, prove), read_page, CRC
   and store fault-in ms a page. The same at device and host budgets of 8
   pages: pages spill and come off disk again, the documents unchanged.
   The drills: a store.read bitflip raises IntegrityError (counted as
   store_read_corrupt_total and sdc_detected_total) and, in a crowd,
   refuses the one height it struck (None; the others as before); a
   truncated and a garbage file are quarantined by the next re-index; and
   ``python -m celestia_tpu_torch.cli store verify`` exits 1 on the damaged
   store and 0 once it is clean.
6e. The chain (``chain``): bench.py config 8b's 60 PFBs signed by the
   port's keys, CheckTx, DeliverTx and commit through the port's keepers
   by hand (``chain_check``, ``chain_deliver``), the three refusals, and
   the block's square assembled and rooted on the card; the app hash and
   DAH equal CHAIN_APP_HASH and CHAIN_DAH_HASH.
6f. The App (``app``): the same block through the port's own entry
   points. App A, the proposer, with a blob arena, and App B, a replica,
   both on the card with the default ``auto`` backend, from one genesis
   (6e's account, one validator bonded from a second key, the governance
   square size raised to k = 128). Height 1 is empty (A proposes, B
   accepts, both commit, equal app hashes). CheckTx of the 60 on both, the
   blobs staged in A's arena at admission. Height 2 on the card, with the
   launch counts from 0 before each entry: A.prepare_proposal keeps the
   60 at k = 128 and launches assemble_square 1, K2 1, K1 3, nmt_tree 1
   (arena_stats assembled 1, fallback 0); B.process_proposal accepts,
   launching K2 1, K1 3, nmt_tree 1; both deliver and commit to
   APP_HASH_2; the proposal's DAH is CHAIN_DAH_HASH; A.extend_block gives
   a device-resident EDS with the same DAH. After each call the
   ``extend.block`` span says backend "gpu" and no strike, fallback,
   quarantine or ProcessProposal panic was counted. Height 3: a transfer
   channel opened on both, then a MsgRegisterEVMAddress, a MsgTransfer
   (escrow and a packet commitment) and a MsgSend through both Apps to
   APP_HASH_3, and the Blobstream valset EndBlock wrote carries the
   registered EVM address. The drill, on separate replicas over a k = 32
   proposal of the block's first two PFBs (on the card): one armed
   device.extend error (not the device's unavailability) is no degrade:
   ProcessProposal panics and votes no, with no strike; one armed
   unavailable device.extend is one strike and one counted fallback with the DAH
   unchanged; three in a row disable the device path (sticky); under
   audit_level "full" a device.extend.output bitflip quarantines, with
   ``last_sdc["befp_provable"]`` True. The ``app`` line times PrepareProposal
   (split into filter_txs, build_square and the DAH), ProcessProposal,
   DeliverTx a tx, commit and ExtendBlock; the ``crossover`` line is
   ``calibration.measure_crossover`` (gpu against native at k = 1-128).
6g. The node (``node``): config 8b's traffic through the port's Node, in a
   fresh temporary directory removed at the end. Node P (the proposer, its
   App with a blob arena) and node R (a replica), both on the card with
   ``extend_blocks`` and a home, from 6f's genesis. P produces the empty
   height 1 and R applies it (``apply_external_block`` with
   ``expected_height``); R saves the snapshot the replay starts from. The
   60 PFBs go through ``broadcast_tx`` on both (P stages their blobs at
   admission); P produces height 2 from its mempool (the 60 in broadcast
   order at k = 128, APP_HASH_2, CHAIN_DAH_HASH) and R applies it: equal
   app hashes and ``blocks/2.json`` bytes, empty mempools, every tx in
   ``get_tx``. Height 3: 60 more PFBs (blob seed PROPOSAL_SEED + 1,
   sequences 60-119) to NODE_APP_HASH_3 and NODE_DAH_HASH_3. Each
   ``produce_block`` and ``apply_external_block`` runs with the counts
   from 0 and must launch what NODE_LAUNCHES derives from APP_LAUNCHES and
   the persist's row levels (PERSIST_LAUNCHES): P's ProcessProposal of its
   own block assembles from its arena too (assemble_square 2, K2 4, K1 9,
   nmt_tree 4; R: K2 3, K1 6, nmt_tree 3), with ``extend.block``
   backend "gpu", no degrade counted and ``node_retention_failures_total``
   at 0. Then R restarts through ``Node.load``: it replays heights 2 and 3
   from the height-1 snapshot, checking both squares with ONE
   ``batched_roots_device`` call (B = 2, launching what phase 5 counted for
   B = 2), answers ``block_dah(2)`` from the store, and serves a 64-sample
   crowd over heights 2 and 3 from disk with one ragged_gather launch,
   every proof verified against the stored row roots. A third node
   state-syncs from P's snapshot to P's app hash; a payload with one
   flipped byte of state is refused. The ``node`` line times broadcast_tx
   a tx, produce_block and apply_external_block (split into
   PrepareProposal, ProcessProposal, deliver + commit, retention and
   persist from the spans) and Node.load (its replay and batched check).
6h. The device lane (``lane``): bench.py's square at k = 128 (seeds 42-47)
   through the serial entries (extend_and_root_device, then
   eds_row_levels_device), then through a bare 3-deep ``BlockPipeline``
   with the counts from 0 (PIPELINE_LAUNCHES a block); every retired block's
   EDS, roots, DAH and levels must equal the entries' bytes, in feed order,
   no retired array may be a view of the pipeline's three pinned result
   sets, and ``feed`` after ``drain`` must raise Shed("draining"). The same
   six at depth 1 are the fenced serial reference. Then ``devledger.end_warmup``
   and a second 3-deep stream under strict retraces: no RetraceError, and
   the ledger's unattributed device bytes no more than before it. Three
   squares through ``Node.extend_pipeline`` on a node with a home: the
   adopted DAH memo, 32 reads a height from the cache with the provers
   from the fetched levels (no launch), the store's DAH, levels and first
   page; the six through home-less nodes' ``extend_pipeline`` at depth 3,
   in turns with depth 1, time the node's own adopting stream. A node with
   phase 6b's four heights (6b's own has read its squares to the host)
   gets a ``DeviceDispatcher`` attached as a server attaches it
   (``node.dispatcher``, ``transfers.register_device_executor``); 8
   request threads submit 6b's 256-sample crowd as ``("sample",)`` batch
   jobs: the documents equal a direct ``sample_batch_ragged``, one
   ragged_gather a batch and nothing else, ``device_busy_ratio`` above 0.
   With the dispatcher attached, the six squares go through
   ``Node.extend_pipeline`` on another node: every leg on the dispatcher's
   thread (its ``dispatch.run`` spans), PIPELINE_LAUNCHES a block, the
   blocks and the adopted DAHs equal to the serial entries'.
   A ``dispatch.run`` delay stalls a capacity-1 dispatcher for one
   ``queue_full`` shed and one deadline expiry, each counted once. The
   codec service's four calls at k = 32 and 128 (Repair on bench.py's
   first 25% mask) through its method bodies, marshalled bytes in and
   out, on the card (``CodecBackend()``) and the host backend
   (``CodecBackend(device="cpu")``): equal bytes, launches as
   CODEC_EXTEND_LAUNCHES (Roots none, Repair its planned sweeps), no
   degrade; and, where grpc imports, a loopback client's ExtendAndRoot.
   ``lane`` lines: ``pipeline`` (the stream's, the depth-1 and the serial
   entries' wall seconds, each leg's wall), ``ledger`` (``debug_doc()``:
   owners, live, attributed and unattributed bytes, builds by entry),
   ``node_pipeline`` (with the adopting stream's seconds),
   ``dispatcher`` (batches, jobs a batch, launches, busy ratio, the
   dispatched pipeline's seconds), ``dispatcher_drill`` and ``codec`` (ms of each call on
   the card and on the host, the transport). Phase 7 adds a ``lane`` line
   ``xor_crossover`` beside the ``xor_table`` line:
   ``calibration.measure_xor_crossover`` at k = 32 and 64, the same
   table's launches timed by CUDA events under the same rule.
6i. Multi-GPU (``mesh``), at k = 128 over bench.py's square (seeds
   42-45). The tree kernel's row-block mode (``nmt_cuda.nmt_tree_rows``)
   against its plain version: every row block of ``row_blocks(k)`` (a
   mesh shard's top and bottom rows, ranges across and inside the halves)
   with its levels, and the column roots through the grid's transpose,
   under phase 2's namespace squares at k = 1, 8 and 128. Then meshes of
   virtual shards on cuda:0, (dp, sp) = (1, 2), (1, 4) and (2, 2) (the
   same over distinct cards where the machine has several): under
   ``parallel.configure_mesh`` roots_device, extend_roots_device,
   extend_roots_device_resident, extend_and_root_device and
   eds_row_levels_device equal the single-device route, Row C
   (extend_root_levels_staged on the mesh) equals the unfused single-device
   pair, and the XOR spelling equals the dense one; roots_device and Row C
   launch ``mesh_launches``, and their ms (host clock, and Row C's by CUDA
   events; medians of 10 turns, each sp = 1 and then the mesh) stand with
   the bytes the collectives copied (on one card the shards run in turn:
   the cost of sharding, not a speed-up). An sp of 3 falls
   back to the single-device route. The main path: phase 6h's six squares
   through a 3-deep BlockPipeline on the (1, 2) mesh with the counts from 0
   (``mesh_launches(2, "row_c")`` a block), every block equal to the
   single-device entries'. Multi-host: a one-rank NCCL group extends a
   square on a (1, 2) mesh and gathers its DAH; two processes on the one
   card (this script again, ``--multihost-worker``) form a gloo group,
   named (NCCL refuses two ranks on one card), each extending its dp
   square, and both gather DAHs equal to the host path's.
6j. The network surface (``rpc``), in a fresh temporary directory removed at
   the end, every server on 127.0.0.1 at port 0. First 6b's crowd over HTTP
   from RPC_THREADS threads against a node C holding 6b's four squares, C's
   server the only one, so its dispatcher is the process's device executor
   as a node's is: every document equals the in-process
   ``sample_batch_ragged`` answer, one ragged_gather a dispatcher batch and
   nothing else, but for a batch whose rows are all in their heights' row
   memos, which launches none (its ``main_path`` line); the same crowd in
   process from the main thread then funnels its gather through the
   dispatcher (one internal ``dispatch.run`` a gather). Then node P (6g's
   proposer, its App with a blob arena and a home) behind its ``RpcServer``
   produces the empty height 1 and config 8b's block through ``POST
   /produce_block`` (the 60 PFBs in through ``RpcClient.broadcast_tx``), with
   the counts from 0
   (NODE_LAUNCHES["produce_block"]); node R, a replica behind its own
   server, applies each block it fetched over the RPC. ``GET /dah/2`` from
   both hashes to CHAIN_DAH_HASH and ``GET /eds/2``'s rows hash to its row
   roots; ``GET /proof/tx/2:RPC_PROOF_TX`` and ``GET /namespace_data/2/`` of
   a namespace no blob has (no range, its absence document), whose squares
   P and R extend on the dispatcher's thread, equal the in-process
   documents. 60 more PFBs and ``Node.produce_block`` in process make height 3
   (NODE_DAH_HASH_3, the same launches). A ``FraudAwareLightClient`` over
   both servers accepts heights 1 and 2, rescreens and samples
   RPC_LC_SAMPLES cells of height 2, every proof verified; against a
   ``testutil/malicious`` node that committed a bad encoding, whose BEFP a
   read-only node proved from the served square and serves, it raises
   ``FraudDetected``. The prober runs RPC_PROBE_CYCLES
   cycles against P with share proofs and the host crosscheck, all ok;
   ``/readyz`` answers 200, then 503 once P's dispatcher drains; ``/metrics``
   parses as Prometheus text and carries ``rpc_stage_ms``; where grpc
   imports, a ``GrpcClient`` reads ``Status`` and broadcasts a send. Then
   ``python -m celestia_tpu_torch.cli start --device cuda`` on a fresh home
   with a RPC_CLI_BLOCK_TIME block time, its blocks produced on its
   dispatcher's thread: ``cli query`` answers, a PFB of RPC_CLI_PFB_BYTES
   through ``cli tx pfb`` lands in a block of k >= GPU_MIN_SQUARE (extended
   on the card), ``cli light`` accepts and samples that height, its
   ``/metrics`` counts the samples' ragged reads from the card's pages, and
   SIGINT drains it to exit 0 with its snapshot saved. The ``rpc`` line: ms
   a sample over HTTP and in process, ms of ``/dah``, ``/eds``, ``/proof/tx``,
   the absent ``/namespace_data``, ``POST /produce_block`` and
   ``Node.produce_block``, the crowd's batches, launches and funnelled runs,
   the CLI node's PFB block, and the phase's seconds.
6k. Harnesses and scenarios (``harness``), in a fresh temporary directory
   removed at the end, every server on 127.0.0.1 at port 0. (a) Three
   ``testutil/chaosnet`` ``RpcChaosNode``s paged on the card (HARNESS_K =
   128, the four HARNESS_HEIGHTS of seed HARNESS_SEED, a device budget of
   HARNESS_BUDGET_HEIGHTS heights' pages, so pages demote and fault in),
   each behind its ``RpcServer``, all three behind one ``node/gateway``
   ``Gateway``; HARNESS_SAMPLES ``/sample`` requests through the gateway from
   RPC_THREADS threads answer the documents of a non-paged
   ``RpcChaosNode(device="cpu")`` of the seed, every proof verified against
   its DAH, which equals the host ``da`` path's (numpy's Leopard, hashlib's
   NMT) at height 1; the crowd launches ragged_gather and nothing else, at
   most one a dispatcher batch (its ``main_path`` line). With three servers in
   one process no device executor is registered (``ops/transfers``, as in
   the JAX package). (b) One backend leaves the ring and stops; a node with
   ``heights=0`` over its store directory re-indexes it, serves the
   pre-restart heights' DAHs and NMT-verified samples while its store's page
   reads rise, and rejoins the ring. (c) A ``scenarios`` ``ScenarioWorld`` at
   k = 128 with ``sdc_producer`` runs its audited production
   (``_produce_block_device``: the chunked upload at ``scenario.stage``, then
   ``extend_roots_device`` under full audits) for HARNESS_SDC_HEIGHTS heights,
   a ``device.extend.output`` bitflip striking the second and a sticky
   ``transfer.chunk`` one the third: both detected and quarantined with the
   host DAH, none missed, every committed DAH the host's; a clean block
   launches K1 3, K2 1 and the tree 1 (its ``main_path`` line). (d) The
   ``smoke`` scenario twice on HARNESS_SMOKE_SEED with the world on the card:
   both verdicts pass, the fault timelines are equal and blocks were made
   on the card. The ``harness`` lines: the ring's split of the crowd, hedges,
   ms a sample through the gateway against direct to one backend, the pages'
   demotions and fault-ins, the restart's re-index seconds and page reads,
   the clean audited block's ms and launches, the smoke runs' walls and
   blocks, and the phase's seconds.
7. Timing, after warm-up: each kernel at its main-path shapes (K2 at
   k = 64 and 128, on Q0 and on the EDS), as its own device time per launch
   (torch.profiler's CUDA records, mean of 10 launches) and as CUDA-event
   time per launch (median of 10 samples of 10 back-to-back launches),
   beside its bound and its plain version (CUDA events, median of 10 calls;
   3 for K2 on the k = 128 EDS); the tree kernel at k = 64 and 128, on
   both families (an extend's launch) and on the rows with their levels
   (eds_row_levels_device's), beside both terms of its bound
   (``nmt_tree_floor``: all nodes at the card's rate, and one tree's chain
   of levels, rounds only) and the floor of its level-at-a-time design
   (``chain_floor_seconds``); K3 at the shapes of one device DAH (its 10
   launches), bound the same way; the merkle kernel at k = 64 and 128 on
   the tree kernel's roots, beside the same bound and the 10 K3 launches;
   K5/K6 beside the function bound and the XOR spelling's own
   floors (its operations on the ALU pipe, its operand reads from shared
   memory, and this layout's reads); the decode sweep at k = 128 and 64 (a
   random mask's row sweep) beside its bound, counted from
   rs.decode_program and the plan's data (``decode_sweep_work``), and
   its plain version (median of 3); the assembly at config 8b's square
   beside its bound (every cell written, every blob byte and host row read
   once), its copy floor (the device time of one device-to-device copy_
   of the square's 8 MiB: the same bytes moved, not the same function) and
   its plain version (median of 3); and K6 with the layout's levers undone
   one at a time (``xor_levers``: the rows' or the nodes' conflict-free
   order shuffled, 8 groups instead of 4); end to end (host clock, H2D and D2H included) at k = 64 and
   128, 20 calls of roots_device and extend_roots_device_resident per route
   with the routes in turns (median, quartiles, best), and the median of 10
   calls of eds_row_levels_device (which takes an EDS and runs no extend, so
   no route); the dense/XOR routing table by device time (K1 against K5 at
   k = 16, 32, 64 and 128, the only kernels in which the fused routes
   differ); and a torch.profiler breakdown of one k = 128 roots_device and
   one extend_roots_device_resident call per route (device time by op,
   launches, aten ops beside the kernels, H2D copies and their ms, idle
   share), and of the device DAH alone (``merkle_root_pow2`` on the k = 128
   roots); on the fused dense route roots_device must launch no aten op
   (no EDS is assembled) and the resident path at most one (Q0's copy
   into the EDS), and the device DAH none and no H2D copy. The median of
   10 calls of extend_and_root_device at k = 64 and 128.

Every measurement is one JSON line carrying the card's name and power limit.
The ``phase_seconds`` line gives each phase's wall seconds (from its first
line to the next phase's; "1" includes the build). Then come the ``kernels`` line (the twelve
kernels, the tree's row-block mode timed at the (1, 2) mesh's shard block
with its launches from phase 6i's pipeline; the ragged gather timed
at the full-width crowd's bucket, its library time the device time of
torch.cat of the bucket's row views; the assembly at config 8b's square), the card as nvidia-smi reports it, and the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import importlib.util
import json
import os
import pathlib
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, int8
# tensor-core rate, and 67 TFLOP/s fp32, which is 132 SMs x 128 FP32 lanes x
# 2 x the 1.98 GHz clock used below. Per SM and clock (NVIDIA H100 Tensor
# Core GPU Architecture white paper, the GH100 SM: four sub-partitions, each
# with 16 INT32 lanes, 32 FP32 lanes and one warp instruction dispatched per
# clock): 64 lanes on the integer ALU pipe (LOP3, SHF, IADD3, PRMT), 128 on
# the FMA pipe that also runs IMAD, and 128 issue slots for both together.
# The shared-memory lookup rate is an estimate (one 32-bank wavefront per
# clock per SM: 32 byte lookups without bank conflicts). One SHA-256
# compression's operations are counted from the compiled SASS of K3's block
# loop (phase 1), not estimated.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SMS = 132
CLOCK_HZ = 1.98e9
ALU_LANES = 64
FMA_LANES = 128
ISSUE_LANES = 128
LOOKUPS_PER_S = 32 * SMS * CLOCK_HZ
SMEM_WAVEFRONT_WORDS = 32  # 4-byte words one shared-memory wavefront serves
SHA_ALU_OPS = ("LOP3", "SHF", "IADD3", "PRMT")
# the FFT spelling of the encode, per 4-lane word: a multiply butterfly is 4
# byte permutes (lookup addresses), 3 permutes (assembly) and 2 XORs beside
# its 4 lookups; a butterfly with a zero twiddle is 1 XOR
FFT_MUL_OPS = 9
FFT_PLAIN_OPS = 1
# a multiply by a constant into a new word (the decode's scale and unscale):
# the 4 address and 3 assembling permutes, no XOR
CONST_MUL_OPS = 7
CELL_BYTES = 512  # byte lanes of a share
LEAF_BLOCKS = 9  # 542-byte NMT leaf message
NODE_BLOCKS = 3  # 181-byte NMT node message
DAH_BLOCKS = 2  # 91-byte merkle leaf and 65-byte merkle node messages of the DAH

# pkg/da/data_availability_header_test.go:28, :44, :50
MIN_DAH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
TYPICAL_DAH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
MAX_DAH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"

SEED = 20261017
REPS = 10
E2E_REPS = 20
TABLE_K = (16, 32, 64, 128)  # the routing table's rungs

# route name: (CELESTIA_FUSED_KERNELS, CELESTIA_XOR_SCHEDULE, its encode kernel)
ROUTES = {
    "fused-dense": ("1", "0", "encode2d_hash"),
    "fused-xor": ("1", "1", "encode2d_xor_hash"),
    "unfused-dense": ("0", "0", "encode2d"),
    "unfused-xor": ("0", "1", "encode2d_xor"),
}
PIN_VARS = ("CELESTIA_FUSED_KERNELS", "CELESTIA_XOR_SCHEDULE")


@contextlib.contextmanager
def pinned(route: str):
    """Run the block under the env pins that select ``route``."""
    saved = {v: os.environ.get(v) for v in PIN_VARS}
    os.environ.update(zip(PIN_VARS, ROUTES[route][:2]))
    try:
        yield
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


# the serving phase (6b): four heights of bench.py's square at k = 128 in a
# node's default paged cache, a crowd of 256 samples over them, and the same
# at a budget of 8 pages
SERVING_HEIGHTS = (1, 2, 3, 4)
SERVING_K = 128
SERVING_SAMPLES = 256
SERVING_TIGHT_PAGES = 8

# every kernel of the port: its source and the TPU kernel (or XLA graph) it
# replaces, as the ``kernels`` line names them
KERNEL_SOURCES = {
    "encode2d_hash": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:276"),
    "leaf_digests2d": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:295"),
    "sha256_words": ("celestia_tpu_torch/csrc/sha256_words.cu",
                     "celestia_tpu/ops/sha256_pallas.py:129"),
    "encode2d": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:270"),
    "encode2d_xor_hash": ("celestia_tpu_torch/csrc/xor_schedule.cu",
                          "celestia_tpu/ops/xor_schedule.py:537"),
    "encode2d_xor": ("celestia_tpu_torch/csrc/xor_schedule.cu",
                     "celestia_tpu/ops/xor_schedule.py:476"),
    # the tree form of K3: every NMT level of extend_tpu._nmt_reduce_once
    "nmt_tree": ("celestia_tpu_torch/csrc/nmt_tree.cu", "celestia_tpu/ops/sha256_pallas.py:129"),
    # its row-block mode: a mesh shard's row levels, the XLA nmt_reduce_levels
    # of parallel.extend_root_levels_rowsharded
    "nmt_tree_rows": ("celestia_tpu_torch/csrc/nmt_tree.cu",
                      "celestia_tpu/parallel/__init__.py:338"),
    # the repair sweep, an XLA graph in JAX (no Pallas kernel)
    "decode_sweep": ("celestia_tpu_torch/csrc/rs_decode.cu", "celestia_tpu/ops/repair_tpu.py:124"),
    # the merkle form of K3: every level of extend_tpu.merkle_root_pow2
    "dah_merkle": ("celestia_tpu_torch/csrc/dah_merkle.cu", "celestia_tpu/ops/sha256_pallas.py:129"),
    # the ragged cross-height gather, an XLA graph in JAX (no Pallas kernel)
    "ragged_gather": ("celestia_tpu_torch/csrc/ragged_gather.cu", "celestia_tpu/ops/ragged.py:51"),
    "assemble_square": ("celestia_tpu_torch/csrc/assemble_square.cu",
                        "celestia_tpu/ops/extend_tpu.py:766"),
}

# the proposal phase (6c): bench.py config 8b's traffic (bench.py:726-757),
# 60 blobs of 120,000 random bytes (seed 11), each in its own v0 namespace,
# at k = 128. A signed PFB is 333-337 bytes (the JAX package's sign_tx of one
# MsgPayForBlobs); the port cannot sign yet, so each BlobTx carries a fixed
# inner tx of that length, opaque to square construction.
PROPOSAL_K = 128
PROPOSAL_BLOBS = 60
PROPOSAL_BLOB_BYTES = 120_000
PROPOSAL_SEED = 11
PFB_INNER_BYTES = 337
# the assembly kernel's input families (kernel against plain, phase 6c)
ASSEMBLY_FAMILIES = ("one_blob", "many_blobs", "host_over_blob", "uncovered", "no_blobs",
                     "arena_edge", "misaligned")
FIRST_SPARSE, CONT_SPARSE = 478, 482  # data bytes of a blob's first and later shares
FIRST_PREFIX, CONT_PREFIX = 34, 30  # the bytes before them: namespace, info[, length]
# the chain phase (6e): bench.py config 8b's block signed as bench.py:741-757
# signs it (one key, chain "bench", account number 0, sequences 0..59,
# Fee(amount=gas, gas_limit=gas) with gas = estimate_gas([120000])), by the
# port's own keys; the signer's genesis balance pays every fee
CHAIN_ID = "bench"
CHAIN_KEY_SECRET = b"bench-arena"
CHAIN_GENESIS_BALANCE = 10**12
CHAIN_BLOCK_TIME = 15.0  # the first block's time, genesis at 0
# the block's app hash after commit and its DAH hash; tests/
# test_torch_chip_smoke.py recomputes both on the CPU with the JAX
# package's keepers and host extend fed the port-signed txs
CHAIN_APP_HASH = "abcd28f1bb474554d23538eb66bc325d7b7c5c400d423a5ac520ea44c7861458"
CHAIN_DAH_HASH = "19f5dd86ca1ab4df234954841a0964f49d702ba3639fe44140c61c4cd249cfc1"
# the App phase (6f): 6e's signer, and one genesis validator bonding from a
# second key; block times 15, 30 and 45 s after a genesis at 0
APP_VALIDATOR_SECRET = b"bench-validator"
APP_VALIDATOR_BALANCE = 10**9
APP_VALIDATOR_BOND = 10**8
APP_BLOCK_TIMES = (15.0, 30.0, 45.0)
# height 3: the validator's EVM address, and what the signer sends over the
# transfer channel (escrowed) and to the validator
APP_EVM_ADDRESS = "0x" + "c0ffee" * 6 + "beef"
APP_CHANNEL = "channel-0"
APP_TRANSFER = 1_000_000
APP_SEND = 2_500
APP_FEE, APP_GAS = 2_000, 200_000
# the app hashes after heights 2 and 3; tests/test_torch_chip_smoke.py
# recomputes both with the JAX package's App on the CPU
APP_HASH_2 = "3ba138f385c54c9d9db00aa4423c428e1eee713924d133e8f706ea3fec1c0e23"
APP_HASH_3 = "b98f5bf1ec1b5e7b5517d064a2d80731036a2d6436023108e3b8690d56831db9"
# the node phase (6g): height 3 is 60 more PFBs of config 8b's traffic (blob
# seed PROPOSAL_SEED + 1, the signer's sequences 60-119) after 6f's height 2;
# tests/test_torch_chip_smoke.py recomputes the app hash and the DAH hash
# with the JAX package's App on the CPU
NODE_SEED_3 = PROPOSAL_SEED + 1
NODE_APP_HASH_3 = "d636f79a848566afdf652a71822437d7dd9f756a1e9dcd50fc7f2b204056fab2"
NODE_DAH_HASH_3 = "969f3012b031e6768cf3eca1ee7ce154e0947f17796613074abe53f852bf9f88"
NODE_CROWD = 64  # samples of the restarted replica's crowd over heights 2 and 3
# the device lane phase (6h): bench.py's square at k = 128 (seeds 42-47)
# through the block pipeline, the phase-6b node's crowd through the
# dispatcher, and the codec service at k = 32 and 128
LANE_SEEDS = (42, 43, 44, 45, 46, 47)
# the multi-GPU phase (6i): bench.py's square at k = 128 (seeds 42-45), the
# meshes of virtual shards on cuda:0 (and over distinct cards where there are
# several), the mesh of the pipeline (the main path of the row-block mode),
# calls a timing, and the tree's row-block cases: (k, namespace squares)
MESH_SEEDS = (42, 43, 44, 45)
MESH_SHAPES = ((1, 2), (1, 4), (2, 2))
MESH_MAIN = (1, 2)
MESH_REPS = 10
MESH_TREE_CASES = ((1, ("random",)), (8, ("random", "tail_padding", "single_namespace")),
                   (128, ("random", "single_namespace")))
LANE_NODE_BLOCKS = 3  # squares through Node.extend_pipeline
LANE_THREADS = 8  # request threads of the dispatcher's crowd
CODEC_KS = (32, 128)


def serving_crowd(seed: int, heights, width: int, n: int) -> list[tuple[int, int, int]]:
    """n DAS samples (height, row, column), uniform over the heights and
    over the cells of a width x width square."""
    r = np.random.default_rng(seed)
    hs = r.choice(np.asarray(heights), size=n)
    cells = r.integers(0, width, size=(n, 2))
    return [(int(h), int(i), int(j)) for h, (i, j) in zip(hs, cells)]


def gather_case(pages_of, payloads, rows_per_page: int) -> tuple[list, list[int], list[int]]:
    """The bucket a crowd's ragged gather reads, as the kernel takes it: the
    unique pages in first-use order (``pages_of(h)[i // rows_per_page]``)
    and one (slot, row in page) descriptor per distinct (height, row)."""
    pages, slot_of, slots, rows, seen = [], {}, [], [], set()
    for h, i, _j in payloads:
        if (h, i) in seen:
            continue
        seen.add((h, i))
        key = (h, i // rows_per_page)
        if key not in slot_of:
            slot_of[key] = len(pages)
            pages.append(pages_of(h)[i // rows_per_page])
        slots.append(slot_of[key])
        rows.append(i % rows_per_page)
    return pages, slots, rows


def config_8b_blobs(seed: int = PROPOSAL_SEED, n: int = PROPOSAL_BLOBS,
                    size: int = PROPOSAL_BLOB_BYTES) -> list:
    """bench.py config 8b's blobs in its draw order (bench.py:741-757),
    each in its own v0 namespace."""
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch import namespace as ns

    r = np.random.default_rng(seed)
    return [blob_pkg.new_blob(ns.new_v0(b"arena" + i.to_bytes(5, "big")),
                              r.integers(0, 256, size, dtype=np.uint8).tobytes(), 0)
            for i in range(n)]


def proposal_txs(seed: int = PROPOSAL_SEED, n: int = PROPOSAL_BLOBS,
                 size: int = PROPOSAL_BLOB_BYTES) -> list[bytes]:
    """bench.py config 8b's blob txs with a fixed inner tx: a byte string
    of a signed PFB's length with the tx's index in front."""
    from celestia_tpu_torch import blob as blob_pkg

    filler = np.random.default_rng(seed + 1).integers(
        0, 256, PFB_INNER_BYTES - 2, dtype=np.uint8).tobytes()
    return [blob_pkg.marshal_blob_tx(i.to_bytes(2, "big") + filler, [b])
            for i, b in enumerate(config_8b_blobs(seed, n, size))]


def sign_chain_tx(key, msg, blob, sequence: int) -> tuple:
    """One PFB of ``blob`` signed as bench.py signs it: (the Tx, the
    BlobTx's bytes)."""
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch.tx import Fee, sign_tx
    from celestia_tpu_torch.x.blob.types import estimate_gas

    gas = estimate_gas([len(blob.data)])
    tx = sign_tx(key, [msg], CHAIN_ID, 0, sequence, Fee(amount=gas, gas_limit=gas))
    return tx, blob_pkg.marshal_blob_tx(tx.marshal(), [blob])


def chain_genesis(address: str):
    """App.init_chain (celestia_tpu/app/app.py:238-267) with the port's
    keepers: the blob params, the block time key, mint's genesis, and
    ``address`` funded. Returns the committed StateStore."""
    from celestia_tpu_torch.state import StateStore
    from celestia_tpu_torch.x.auth import AccountKeeper
    from celestia_tpu_torch.x.bank import BLOCK_TIME_KEY, BankKeeper
    from celestia_tpu_torch.x.blob.keeper import BlobKeeper, Params
    from celestia_tpu_torch.x.mint import MintKeeper

    store = StateStore()
    bank = BankKeeper(store)
    BlobKeeper(store).set_params(Params())
    store.set(BLOCK_TIME_KEY, repr(0.0).encode())
    MintKeeper(store, bank).init_genesis(0.0)
    AccountKeeper(store).get_or_create(address)
    bank.mint(address, CHAIN_GENESIS_BALANCE)
    store.commit()
    return store


def _chain_context(store, mode, block_time: float):
    from celestia_tpu_torch.app.context import Context

    return Context(store=store, chain_id=CHAIN_ID, block_height=1, block_time=block_time,
                   app_version=1, mode=mode)


def chain_check(check_store, raw: bytes, times: dict | None = None) -> tuple[int, str]:
    """App.check_tx (app.py:704-746) of a BlobTx on the persistent check
    branch: validate_blob_tx, then the ante in CHECK mode on a branch of
    it, written back when the ante passes. Returns (code, log); ``times``
    collects the ms of each step."""
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch.app.ante import AnteHandler
    from celestia_tpu_torch.app.context import ExecMode
    from celestia_tpu_torch.x.blob.types import validate_blob_tx

    btx, _is_blob = blob_pkg.unmarshal_blob_tx(raw)
    try:
        t0 = time.perf_counter()
        tx = validate_blob_tx(btx)
        t1 = time.perf_counter()
        branch = check_store.branch()
        AnteHandler()(_chain_context(branch, ExecMode.CHECK, 0.0), tx, len(btx.tx))
        t2 = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — a refused tx is its result code, as in the App
        return 1, str(e)
    branch.write()
    if times is not None:
        times.setdefault("validate_blob_tx", []).append((t1 - t0) * 1e3)
        times.setdefault("check_ante", []).append((t2 - t1) * 1e3)
    return 0, ""


def chain_deliver(store, raws: list[bytes], times: dict | None = None) -> tuple[list, bytes]:
    """App.begin_block, deliver_tx of each tx and commit (app.py:890-976,
    :1281-1293) with the port's keepers: mint's and distribution's begin
    blockers on the deliver branch; per tx the ante on a branch, then
    BlobKeeper.pay_for_blobs on another; then the deliver branch written
    and committed. Returns the (code, log) of each tx and the app hash."""
    import dataclasses

    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch.app.ante import AnteHandler
    from celestia_tpu_torch.app.context import ExecMode
    from celestia_tpu_torch.tx import decode_tx
    from celestia_tpu_torch.x.bank import BLOCK_TIME_KEY, BankKeeper
    from celestia_tpu_torch.x.blob.keeper import BlobKeeper
    from celestia_tpu_torch.x.blob.types import MsgPayForBlobs
    from celestia_tpu_torch.x.distribution import DistributionKeeper
    from celestia_tpu_torch.x.mint import MintKeeper
    from celestia_tpu_torch.x.staking import StakingKeeper

    deliver = store.branch()
    block_ctx = _chain_context(deliver, ExecMode.DELIVER, CHAIN_BLOCK_TIME)
    deliver.set(BLOCK_TIME_KEY, repr(CHAIN_BLOCK_TIME).encode())
    bank = BankKeeper(deliver)
    MintKeeper(deliver, bank).begin_blocker(block_ctx)
    DistributionKeeper(deliver, bank, StakingKeeper(deliver, bank)).begin_blocker(block_ctx)
    results = []
    for raw in raws:
        t0 = time.perf_counter()
        btx, is_blob = blob_pkg.unmarshal_blob_tx(raw)
        inner = btx.tx if is_blob else raw
        tx = decode_tx(inner)
        ante_store = deliver.branch()
        ctx = dataclasses.replace(block_ctx, store=ante_store, events=[])
        try:
            ctx = AnteHandler()(ctx, tx, len(inner))
        except Exception as e:  # noqa: BLE001 — as in the App: the tx's result
            results.append((1, str(e)))
            continue
        ante_store.write()
        msg_store = deliver.branch()
        msg_ctx = dataclasses.replace(ctx, store=msg_store)
        try:
            for msg in tx.msgs:
                if not isinstance(msg, MsgPayForBlobs):
                    raise ValueError(f"unroutable message type {type(msg).__name__}")
                BlobKeeper(msg_store).pay_for_blobs(msg_ctx, msg)
        except Exception as e:  # noqa: BLE001 — msg effects roll back, ante's stay
            results.append((1, str(e)))
            continue
        msg_store.write()
        results.append((0, ""))
        if times is not None:
            times.setdefault("deliver", []).append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    deliver.write()
    app_hash = store.commit()
    if times is not None:
        times["commit"] = [(time.perf_counter() - t0) * 1e3]
    return results, app_hash


def app_genesis(app, signer: str, validator: str) -> None:
    """Phase 6f's genesis on an App (the port's, or the JAX package's in
    the tests): 6e's signer and balance, one validator bonding from a
    second account (the staking hook reaches x/blobstream), and the
    governance square size raised from its default of 64 to k = 128, the
    app version's upper bound, which config 8b's block needs."""
    app.init_chain({signer: CHAIN_GENESIS_BALANCE, validator: APP_VALIDATOR_BALANCE},
                   genesis_time=0.0, genesis_validators={validator: APP_VALIDATOR_BOND})
    params = app.blob.get_params()
    params.gov_max_square_size = PROPOSAL_K
    app.blob.set_params(params)
    app.store.commit_hash_refresh()


def app_block(app, txs: list[bytes], block_time: float, times: dict | None = None):
    """BeginBlock, DeliverTx of each tx, EndBlock and Commit: (the tx
    results, the app hash). ``times`` collects the ms of each tx and of the
    commit."""
    app.begin_block(block_time)
    results = []
    for raw in txs:
        t0 = time.perf_counter()
        results.append(app.deliver_tx(raw))
        if times is not None:
            times.setdefault("deliver", []).append((time.perf_counter() - t0) * 1e3)
    app.end_block()
    t0 = time.perf_counter()
    app_hash = app.commit()
    if times is not None:
        times["commit"] = (time.perf_counter() - t0) * 1e3
    return results, app_hash


def open_transfer_channel(app) -> None:
    """The transfer channel's OPEN end as celestia_tpu/testutil/ibc.py:18-25
    opens it (the post-handshake state), on one chain's App."""
    from celestia_tpu_torch.x.transfer import PORT_ID_TRANSFER

    app.ibc.open_channel(PORT_ID_TRANSFER, APP_CHANNEL, PORT_ID_TRANSFER, APP_CHANNEL)
    app.store.commit_hash_refresh()


def app_height3_txs(signer_key, validator_key) -> list[bytes]:
    """Height 3's txs, signed by the port's keys: the validator registers
    its EVM address (account 1, sequence 0); the signer (account 0, after
    the 60 PFBs) sends APP_TRANSFER over the transfer channel and APP_SEND
    to the validator."""
    from celestia_tpu_torch.tx import Fee, sign_tx
    from celestia_tpu_torch.x.bank import MsgSend
    from celestia_tpu_torch.x.blobstream import MsgRegisterEVMAddress
    from celestia_tpu_torch.x.transfer import PORT_ID_TRANSFER, MsgTransfer

    s, v = signer_key.bech32_address(), validator_key.bech32_address()
    fee = Fee(amount=APP_FEE, gas_limit=APP_GAS)
    return [
        sign_tx(validator_key, [MsgRegisterEVMAddress(v, APP_EVM_ADDRESS)], CHAIN_ID, 1, 0,
                fee).marshal(),
        sign_tx(signer_key, [MsgTransfer(PORT_ID_TRANSFER, APP_CHANNEL, "utia", APP_TRANSFER,
                                         s, s)], CHAIN_ID, 0, PROPOSAL_BLOBS, fee).marshal(),
        sign_tx(signer_key, [MsgSend(s, v, APP_SEND)], CHAIN_ID, 0, PROPOSAL_BLOBS + 1,
                fee).marshal(),
    ]


# the counters of the App's degrade, quarantine and refusal paths; phase 6f
# fails if any moves outside its drill
DEGRADE_COUNTERS = ("extend_gpu_fallback_total", "extend_gpu_disabled_total",
                    "sdc_quarantine_total", "process_proposal_panics")
CROSSOVER_REPEATS = 3  # best of, after one warm-up call, per backend and k
DRILL_TXS = 2  # the PFBs of the drill's proposal: k = 32
# what one k = 128 call of each App entry launches on the fused dense route
APP_LAUNCHES = {
    "prepare_proposal": {"assemble_square": 1, "leaf_digests2d": 1, "encode2d_hash": 3,
                         "nmt_tree": 1},
    "process_proposal": {"leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1},
    "extend_block": {"leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1},
}


def degrade_counts(metrics) -> dict[str, float]:
    """Each of DEGRADE_COUNTERS summed over its labels."""
    return {name: sum(v for key, v in metrics.counters.items() if key.split("{")[0] == name)
            for name in DEGRADE_COUNTERS}


def app_phase(dev, emit, signer_key, raws: list[bytes], crossover_out=None) -> None:
    """Phase 6f: config 8b's signed block through the port's App on the card
    (see the module docstring). Every check raises; nothing is caught."""
    import torch

    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch import crypto, da, faults, integrity, tracing
    from celestia_tpu_torch.app import calibration
    from celestia_tpu_torch.app.app import App
    from celestia_tpu_torch.ops import _cuda
    from celestia_tpu_torch.telemetry import metrics
    from celestia_tpu_torch.x.transfer import PORT_ID_TRANSFER, escrow_address

    t_phase = time.perf_counter()
    v_key = crypto.PrivateKey.from_secret(APP_VALIDATOR_SECRET)
    s_addr, v_addr = signer_key.bech32_address(), v_key.bech32_address()
    base = degrade_counts(metrics)

    def clean(app, what: str) -> None:
        now = degrade_counts(metrics)
        check(now == base and app._gpu_strikes == 0 and not app._gpu_disabled
              and not app.sdc_quarantined,
              f"{what}: a degrade outside the drill (counters {now} from {base}, strikes "
              f"{app._gpu_strikes}, disabled {app._gpu_disabled}, quarantined "
              f"{app.sdc_quarantined})")

    def on_card(app, entry: str, call):
        """One App entry with the launch counts from 0 and its spans
        recorded: (its result, wall ms, {span name: ms})."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with tracing.record() as rec:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_cuda.LAUNCHES)
        want = {**dict.fromkeys(counts, 0), **APP_LAUNCHES[entry]}
        check(counts == want, f"App.{entry} launched {counts}: {APP_LAUNCHES[entry]} expected")
        blocks = [sp for sp in rec.spans if sp.name == "extend.block"]
        check(len(blocks) == 1 and blocks[0].attrs.get("backend") == "gpu"
              and not blocks[0].attrs.get("degraded"),
              f"App.{entry}'s extend.block spans: {[sp.attrs for sp in blocks]}")
        clean(app, f"App.{entry}")
        return out, ms, {sp.name: sp.duration * 1e3 for sp in rec.spans}

    def replica(**kw):
        app = App(chain_id=CHAIN_ID, device=dev, **kw)
        app_genesis(app, s_addr, v_addr)
        app_block(app, [], APP_BLOCK_TIMES[0])
        return app

    # height 1, empty by design: A proposes, B accepts, both commit
    a_app = App(chain_id=CHAIN_ID, device=dev)
    a_app.enable_blob_pool()
    b_app = App(chain_id=CHAIN_ID, device=dev)
    for app in (a_app, b_app):
        check(app.extend_backend == "auto" and app.device.type == "cuda",
              f"an App on {app.device} with backend {app.extend_backend}")
        app_genesis(app, s_addr, v_addr)
    p1 = a_app.prepare_proposal([])
    check(p1.txs == [] and p1.square_size == 1 and b_app.process_proposal(p1),
          f"the empty height 1: {p1}")
    h1 = [app_block(app, [], APP_BLOCK_TIMES[0])[1] for app in (a_app, b_app)]
    check(h1[0] == h1[1], f"height 1's app hashes differ: {h1[0].hex()} {h1[1].hex()}")
    clean(a_app, "height 1")
    clean(b_app, "height 1")
    # CheckTx of the 60 on both; A stages each tx's blobs at admission
    check_ms = []
    for app in (a_app, b_app):
        for raw in raws:
            t0 = time.perf_counter()
            res = app.check_tx(raw)
            if app is a_app:
                app.blob_pool.put_many([b.data for b in blob_pkg.unmarshal_blob_tx(raw)[0].blobs])
                check_ms.append((time.perf_counter() - t0) * 1e3)
            check(res.code == 0, f"CheckTx refused a signed PFB: {res.log}")
    a_app.blob_pool.ready()

    # height 2 on the card. The arena's counts are read as the difference
    # this proposal made: height 1's empty square counts a fallback when
    # the crossover table routes k = 1 to the card (no blob to assemble)
    stats0 = dict(a_app.arena_stats)
    p2, prepare_ms, prepare_spans = on_card(a_app, "prepare_proposal",
                                            lambda: a_app.prepare_proposal(raws))
    check(p2.square_size == PROPOSAL_K and p2.txs == raws,
          f"PrepareProposal: k = {p2.square_size}, {len(p2.txs)} of {len(raws)} txs")
    arena = {name: n - stats0[name] for name, n in a_app.arena_stats.items()}
    check(arena == {"assembled": 1, "fallback": 0},
          f"the proposer's arena: {a_app.arena_stats} from {stats0}")
    check(p2.hash.hex() == CHAIN_DAH_HASH,
          f"the proposal's DAH {p2.hash.hex()} != phase 6e's {CHAIN_DAH_HASH}")
    accepted, process_ms, _spans = on_card(b_app, "process_proposal",
                                           lambda: b_app.process_proposal(p2))
    check(accepted is True, "the replica's ProcessProposal refused the proposer's block")
    # more samples of both entries, on the same state (neither commits); the
    # fastest PrepareProposal is reported with its own split
    for _ in range(2):
        _p, ms, spans = on_card(a_app, "prepare_proposal", lambda: a_app.prepare_proposal(raws))
        if ms < prepare_ms:
            prepare_ms, prepare_spans = ms, spans
        process_ms = min(process_ms, on_card(b_app, "process_proposal",
                                             lambda: b_app.process_proposal(p2))[1])
    times: dict = {}
    results, h2 = {}, {}
    for app in (a_app, b_app):
        res, h2[id(app)] = app_block(app, p2.txs, APP_BLOCK_TIMES[1],
                                     times if app is a_app else None)
        results[id(app)] = [(r.code, r.log) for r in res]
        check(all(r.code == 0 for r in res),
              f"DeliverTx refused {[(r.code, r.log) for r in res if r.code][:2]}")
    check(results[id(a_app)] == results[id(b_app)] and h2[id(a_app)] == h2[id(b_app)],
          "the proposer and the replica differ after height 2")
    check(h2[id(a_app)].hex() == APP_HASH_2,
          f"height 2's app hash {h2[id(a_app)].hex()} != the CPU-pinned {APP_HASH_2}")
    eds, extend_ms, _spans = on_card(a_app, "extend_block", lambda: a_app.extend_block(p2.txs))
    check(eds.device_data is not None and eds.device_data.device.type == "cuda",
          "ExtendBlock's EDS is not resident on the card")
    check(da.new_data_availability_header(eds).hash() == p2.hash,
          "ExtendBlock's DAH differs from the proposal's")
    for _ in range(2):
        extend_ms = min(extend_ms, on_card(a_app, "extend_block",
                                           lambda: a_app.extend_block(p2.txs))[1])

    # height 3: the new modules
    t3 = app_height3_txs(signer_key, v_key)
    for app in (a_app, b_app):
        open_transfer_channel(app)
        refused = [r.log for r in map(app.check_tx, t3) if r.code]
        check(not refused, f"CheckTx refused height 3's txs: {refused}")
    p3 = a_app.prepare_proposal(t3)
    check(p3.txs == t3 and b_app.process_proposal(p3), f"height 3's proposal: {p3}")
    h3 = []
    for app in (a_app, b_app):
        res, app_hash = app_block(app, p3.txs, APP_BLOCK_TIMES[2])
        check(all(r.code == 0 for r in res), f"height 3 refused {[r.log for r in res if r.code]}")
        h3.append(app_hash)
        clean(app, "height 3")
    check(h3[0] == h3[1] and h3[0].hex() == APP_HASH_3,
          f"height 3's app hashes {[h.hex() for h in h3]}: the CPU-pinned {APP_HASH_3}")
    valset = a_app.blobstream.latest_valset()
    check(valset is not None and valset["height"] == 3
          and [m["evm_address"] for m in valset["members"]] == [APP_EVM_ADDRESS],
          f"the Blobstream valset after height 3: {valset}")
    packets = a_app.ibc.pending_packets(PORT_ID_TRANSFER, APP_CHANNEL)
    escrowed = a_app.bank.get_balance(escrow_address(PORT_ID_TRANSFER, APP_CHANNEL))
    check(len(packets) == 1 and escrowed == APP_TRANSFER,
          f"the transfer: {len(packets)} packets, {escrowed} escrowed")

    # the drill, on replicas of height 1, over a proposal of the block's
    # first DRILL_TXS PFBs: a square the measured table routes to the card
    # (k = 32), at a tenth of a k = 128 ProcessProposal's host time. First
    # a fault that is not the device's unavailability (as a kernel that
    # fails to launch would raise): it is no degrade, so ProcessProposal
    # panics and votes no, with no strike and no fallback
    t_drill = time.perf_counter()
    d_app = replica()
    p_drill = d_app.prepare_proposal(raws[:DRILL_TXS])
    check(p_drill.txs == raws[:DRILL_TXS]
          and d_app.resolve_extend_backend(p_drill.square_size) == "gpu",
          f"the drill's proposal: k = {p_drill.square_size}, {len(p_drill.txs)} txs, backend "
          f"{d_app.resolve_extend_backend(p_drill.square_size)}")
    clean(d_app, "the drill's proposal")
    counters0 = degrade_counts(metrics)
    with faults.inject(faults.rule("device.extend", "error", times=1), seed=SEED):
        ok = d_app.process_proposal(p_drill)
    moved = {name: n - counters0[name] for name, n in degrade_counts(metrics).items()}
    check(ok is False and d_app._gpu_strikes == 0 and not d_app._gpu_disabled
          and moved == {**dict.fromkeys(DEGRADE_COUNTERS, 0), "process_proposal_panics": 1},
          f"a device.extend error: accepted {ok}, strikes {d_app._gpu_strikes}, "
          f"counters moved {moved}")
    # then one armed device.extend unavailability, then three
    counters0 = degrade_counts(metrics)
    with faults.inject(faults.rule("device.extend", "unavailable", times=1), seed=SEED):
        with tracing.record() as rec:
            ok = d_app.process_proposal(p_drill)
    fallbacks = degrade_counts(metrics)["extend_gpu_fallback_total"] \
        - counters0["extend_gpu_fallback_total"]
    span = [sp for sp in rec.spans if sp.name == "extend.block"][0]
    check(ok and d_app._gpu_strikes == 1 and not d_app._gpu_disabled and fallbacks == 1
          and span.attrs.get("degraded") and span.attrs.get("backend") == "native",
          f"one device.extend fault: accepted {ok}, strikes {d_app._gpu_strikes}, "
          f"fallbacks {fallbacks}, span {span.attrs}")
    check(d_app.process_proposal(p_drill) and d_app._gpu_strikes == 0,
          "a clean call after one strike did not reset the strikes")
    with faults.inject(faults.rule("device.extend", "unavailable", times=3), seed=SEED):
        oks = [d_app.process_proposal(p_drill) for _ in range(3)]
    with tracing.record() as rec:
        ok_after = d_app.process_proposal(p_drill)
    span = [sp for sp in rec.spans if sp.name == "extend.block"][0]
    disabled = degrade_counts(metrics)["extend_gpu_disabled_total"] \
        - counters0["extend_gpu_disabled_total"]
    check(all(oks) and ok_after and d_app._gpu_disabled and d_app._gpu_strikes == 3
          and disabled >= 1 and span.attrs.get("backend") == "native",
          f"three device.extend faults: accepted {oks + [ok_after]}, disabled "
          f"{d_app._gpu_disabled}, strikes {d_app._gpu_strikes}, span {span.attrs}")
    # the quarantine: an audited replica, its device result bit-flipped
    q_app = replica(audit_level="full")
    with faults.inject(faults.rule("device.extend.output", "bitflip", times=1), seed=SEED):
        ok = q_app.process_proposal(p_drill)
    integrity.configure("off")
    check(ok and q_app.sdc_quarantined and q_app._gpu_disabled
          and q_app.last_sdc["befp_provable"] is True,
          f"the quarantine: accepted {ok}, last_sdc {q_app.last_sdc}")
    drill = {"error_panics": moved["process_proposal_panics"],
             "strike_fallbacks": fallbacks, "disabled_counted": disabled,
             "quarantine": q_app.last_sdc}
    base = degrade_counts(metrics)  # the drill's own counts, excluded below

    t_crossover = time.perf_counter()
    crossover = calibration.measure_crossover(calibration.DEFAULT_KS, CROSSOVER_REPEATS, dev)
    _smi, card_name, power_limit = card()
    crossover.card, crossover.power_limit = card_name, power_limit
    check(all(crossover.entries[k].keys() == {"gpu", "native"} for k in calibration.DEFAULT_KS),
          f"the crossover measured {crossover.entries}")
    emit(phase="crossover", ks=list(calibration.DEFAULT_KS), repeats=CROSSOVER_REPEATS,
         entries={str(k): v for k, v in crossover.entries.items()},
         winners={str(k): crossover.winner(k) for k in calibration.DEFAULT_KS})
    if crossover_out:
        crossover.save(crossover_out)
    clean(a_app, "the crossover")
    med = statistics.median
    emit(phase="app", k=PROPOSAL_K, txs=len(raws),
         launches={e: APP_LAUNCHES[e] for e in APP_LAUNCHES},
         check_tx_ms=med(check_ms), prepare_proposal_ms=prepare_ms,
         prepare_split_ms={"filter_txs": prepare_spans["app.filter_txs"],
                           "build_square": prepare_spans["app.build_square"],
                           "dah": prepare_spans["extend.block"]},
         process_proposal_ms=process_ms, deliver_tx_ms=med(times["deliver"]),
         commit_ms=times["commit"], extend_block_ms=extend_ms,
         arena_height_2=arena, arena_stats=a_app.arena_stats, app_hash_2=h2[id(a_app)].hex(),
         app_hash_3=h3[0].hex(), dah=p2.hash.hex(), valset_nonce=valset["nonce"],
         drill=drill, phase_seconds=time.perf_counter() - t_phase,
         split_seconds={"blocks": t_drill - t_phase, "drill": t_crossover - t_drill,
                        "crossover": time.perf_counter() - t_crossover})



# what one k = 128 persist launches (the row levels of
# extend.eds_row_levels_device: K2 on the EDS, the tree with the levels)
PERSIST_LAUNCHES = {"leaf_digests2d": 1, "nmt_tree": 1}


def node_launches(own: bool) -> dict[str, int]:
    """What one k = 128 block through the node launches: its own block
    (``produce_block``, on the proposer with the blob arena) is
    PrepareProposal, ProcessProposal, ExtendBlock and the persist, where the
    proposer's ProcessProposal assembles its square from the arena as its
    PrepareProposal does (the App hands the square's builder to the DAH,
    as the JAX App does); a replica's block (``apply_external_block``, no
    arena) is ProcessProposal, ExtendBlock and the persist."""
    parts = ([APP_LAUNCHES["prepare_proposal"]] * 2 if own else
             [APP_LAUNCHES["process_proposal"]]) + [APP_LAUNCHES["extend_block"],
                                                    PERSIST_LAUNCHES]
    return dict(sum((collections.Counter(p) for p in parts), collections.Counter()))


NODE_LAUNCHES = {"produce_block": node_launches(True),
                 "apply_external_block": node_launches(False)}
# phase 6h: the codec's Encode and ExtendAndRoot on the card run one fused
# extend, as ExtendBlock does (Roots runs on the host; Repair's decode sweeps
# are counted from its plan); a pipelined block (extend_root_levels_staged)
# runs the unfused route: that extend's three quadrant encodes on K4, the
# row levels of the EDS as the persist computes them, one more tree over the
# same leaves for both axes' roots, and their device DAH (dah_merkle)
CODEC_EXTEND_LAUNCHES = dict(APP_LAUNCHES["extend_block"])
PIPELINE_LAUNCHES = dict(sum((collections.Counter(p) for p in (
    {"encode2d": CODEC_EXTEND_LAUNCHES["encode2d_hash"]}, PERSIST_LAUNCHES,
    {"nmt_tree": 1, "dah_merkle": 1})), collections.Counter()))


def node_height3_txs(signer_key) -> list[bytes]:
    """Phase 6g's height 3: 60 PFBs of config 8b's traffic drawn with blob
    seed NODE_SEED_3, signed by 6e's key at sequences 60-119."""
    from celestia_tpu_torch.x.blob.types import new_msg_pay_for_blobs

    addr = signer_key.bech32_address()
    return [sign_chain_tx(signer_key, new_msg_pay_for_blobs(addr, b), b, PROPOSAL_BLOBS + i)[1]
            for i, b in enumerate(config_8b_blobs(NODE_SEED_3))]


def raised(call):
    """The exception ``call()`` raises, or None."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the caller checks which
        return e
    return None


def flip_state_byte(payload: dict) -> dict:
    """A state-sync payload with one byte of its state flipped: the last
    decimal digit of the state's data (a hex digit of a stored value or
    key, which stays a hex digit), so the state parses and restores to
    another app hash."""
    state = bytearray(bytes.fromhex(payload["state"]))
    end = bytes(state).rindex(b'"version"')
    i = max(j for j in range(end) if 0x30 <= state[j] <= 0x39)
    state[i] ^= 1
    return {**payload, "state": bytes(state).hex()}


def retention_failures(metrics) -> float:
    """node_retention_failures_total summed over its reasons."""
    return sum(v for key, v in metrics.counters.items()
               if key.split("{")[0] == "node_retention_failures_total")


def node_phase(dev, emit, signer_key, raws: list[bytes], batched_launches: dict) -> None:
    """Phase 6g: config 8b's traffic through the port's Node on the card (see
    the module docstring). ``batched_launches``: what phase 5's
    batched_roots_device launched for B = 2 at k = 128. Every check raises;
    nothing is caught."""
    import gc
    import shutil
    import tempfile

    import torch

    from celestia_tpu_torch import crypto, da, tracing
    from celestia_tpu_torch.app.app import App
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.node import tx_hash
    from celestia_tpu_torch.ops import _cuda
    from celestia_tpu_torch.ops.blob_pool import blob_key
    from celestia_tpu_torch.proof import NmtRangeProof
    from celestia_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    v_key = crypto.PrivateKey.from_secret(APP_VALIDATOR_SECRET)
    s_addr, v_addr = signer_key.bech32_address(), v_key.bech32_address()
    base, failures0 = degrade_counts(metrics), retention_failures(metrics)

    def clean(node, what: str) -> None:
        app = node.app
        check(degrade_counts(metrics) == base and retention_failures(metrics) == failures0
              and app._gpu_strikes == 0 and not app._gpu_disabled and not app.sdc_quarantined,
              f"{what}: a degrade or a retention failure (counters {degrade_counts(metrics)} "
              f"from {base}, retention failures {retention_failures(metrics) - failures0})")

    def on_node(node, entry: str, call):
        """One block through the node with the counts from 0 and its spans
        recorded: (the block, wall ms, {span name: ms})."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with tracing.record() as rec:
            t0 = time.perf_counter()
            block = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_cuda.LAUNCHES)
        want = {**dict.fromkeys(counts, 0), **NODE_LAUNCHES[entry]}
        check(counts == want, f"Node.{entry} launched {counts}: {NODE_LAUNCHES[entry]} expected")
        blocks = [sp.attrs for sp in rec.spans if sp.name == "extend.block"]
        check(len(blocks) == (3 if entry == "produce_block" else 2)
              and all(a.get("backend") == "gpu" and not a.get("degraded") for a in blocks),
              f"Node.{entry}'s extend.block spans: {blocks}")
        clean(node, f"Node.{entry}")
        spans = {sp.name: sp.duration * 1e3 for sp in rec.spans if sp.name != "extend.block"}
        split = {name: spans[f"app.{name}"] for name in ("prepare_proposal", "process_proposal")
                 if f"app.{name}" in spans}
        split["retention"] = spans["node.extend_retention"]
        split["persist"] = spans["node.persist"]
        split["deliver_commit"] = (spans["node.apply_block"] - split["process_proposal"]
                                   - split["retention"] - split["persist"])
        return block, ms, split

    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-node-"))
    try:
        nodes = {}
        for name in ("p", "r"):
            app = App(chain_id=CHAIN_ID, device=dev)
            if name == "p":
                app.enable_blob_pool()
            app_genesis(app, s_addr, v_addr)
            nodes[name] = Node(app, home=home / name, extend_blocks=True)
            check(app.extend_backend == "auto" and nodes[name].device.type == "cuda"
                  and nodes[name].store is not None,
                  f"node {name} on {nodes[name].device}, backend {app.extend_backend}")
        p_node, r_node = nodes["p"], nodes["r"]

        # height 1, empty; R's snapshot here is the replay's start
        b1 = p_node.produce_block(APP_BLOCK_TIMES[0])
        r1 = r_node.apply_external_block(b1.txs, b1.square_size, b1.data_hash, b1.time,
                                         expected_height=1)
        check(b1.txs == [] and b1.square_size == 1 and r1.app_hash == b1.app_hash,
              f"the empty height 1: {b1.to_json()} and {r1.to_json()}")
        r_node.save_snapshot()

        # height 2: the 60 through broadcast_tx on both, P staging their blobs
        broadcast_ms = {"p": [], "r": []}
        for name, node in nodes.items():
            for raw in raws:
                t0 = time.perf_counter()
                res = node.broadcast_tx(raw)
                broadcast_ms[name].append((time.perf_counter() - t0) * 1e3)
                check(res.code == 0, f"node {name} refused a signed PFB: {res.log}")
            check(len(node.mempool) == len(raws), f"node {name}'s mempool: {len(node.mempool)}")
        arena = p_node.app.blob_pool
        staged = sum(arena.offset_of(blob_key(b.data)) is not None for b in config_8b_blobs())
        check(staged == len(raws), f"P's arena staged {staged} of {len(raws)} blobs")
        stats0 = dict(p_node.app.arena_stats)
        b2, produce_ms, produce_split = on_node(
            p_node, "produce_block", lambda: p_node.produce_block(APP_BLOCK_TIMES[1]))
        check(b2.txs == raws and b2.square_size == PROPOSAL_K
              and b2.app_hash.hex() == APP_HASH_2 and b2.data_hash.hex() == CHAIN_DAH_HASH,
              f"P's height 2: {len(b2.txs)} txs at k = {b2.square_size}, app hash "
              f"{b2.app_hash.hex()}, data hash {b2.data_hash.hex()}")
        check(p_node.app.arena_stats["assembled"] - stats0["assembled"] == 2
              and p_node.app.arena_stats["fallback"] == stats0["fallback"],
              f"P's height 2 was not assembled from its arena: {p_node.app.arena_stats}")
        r2, apply_ms, apply_split = on_node(
            r_node, "apply_external_block",
            lambda: r_node.apply_external_block(b2.txs, b2.square_size, b2.data_hash, b2.time,
                                                expected_height=2))
        check(r2.app_hash == b2.app_hash, f"R's height 2 app hash {r2.app_hash.hex()}")
        check((home / "p/blocks/2.json").read_bytes() == (home / "r/blocks/2.json").read_bytes(),
              "the two nodes' blocks/2.json differ")
        for name, node in nodes.items():
            check(len(node.mempool) == 0 and all(
                node.get_tx(tx_hash(raw)) == (node.get_block(2), i) for i, raw in enumerate(raws)),
                f"node {name} after height 2: {len(node.mempool)} in the mempool, get_tx "
                f"{sum(node.get_tx(tx_hash(raw)) is not None for raw in raws)} of {len(raws)}")
        pre_dah = json.dumps(r_node.block_dah(2).to_json(), sort_keys=True)

        # height 3: 60 more PFBs
        t3 = node_height3_txs(signer_key)
        for raw in t3:
            res = p_node.broadcast_tx(raw)
            check(res.code == 0, f"P refused a height-3 PFB: {res.log}")
        b3, produce3_ms, _split = on_node(
            p_node, "produce_block", lambda: p_node.produce_block(APP_BLOCK_TIMES[2]))
        r3, apply3_ms, _split = on_node(
            r_node, "apply_external_block",
            lambda: r_node.apply_external_block(b3.txs, b3.square_size, b3.data_hash, b3.time,
                                                expected_height=3))
        check(b3.txs == t3 and b3.square_size == PROPOSAL_K
              and b3.app_hash.hex() == r3.app_hash.hex() == NODE_APP_HASH_3
              and b3.data_hash.hex() == NODE_DAH_HASH_3,
              f"height 3: {len(b3.txs)} txs at k = {b3.square_size}, app hashes "
              f"{b3.app_hash.hex()} {r3.app_hash.hex()}, data hash {b3.data_hash.hex()}: "
              f"{NODE_APP_HASH_3} and {NODE_DAH_HASH_3} pinned")
        check((home / "p/blocks/3.json").read_bytes() == (home / "r/blocks/3.json").read_bytes(),
              "the two nodes' blocks/3.json differ")
        check(r_node.store.heights() == [1, 2, 3], f"R's store holds {r_node.store.heights()}")

        # R restarts: the replay of heights 2 and 3 from the height-1
        # snapshot, both squares checked by one batched_roots_device call
        r_home = r_node.home
        del r_node, nodes["r"]
        gc.collect()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with tracing.record() as rec:
            t0 = time.perf_counter()
            r_node = Node.load(r_home, device=dev)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_cuda.LAUNCHES)
        batched = [sp for sp in rec.spans if sp.name == "extend.device"
                   and sp.attrs.get("entry") == "batched_roots_device"]
        check(len(batched) == 1 and batched[0].attrs.get("batch") == 2
              and batched[0].attrs.get("k") == PROPOSAL_K,
              f"Node.load's batched checks: {[sp.attrs for sp in batched]}")
        check(counts == {**dict.fromkeys(counts, 0), **batched_launches},
              f"Node.load launched {counts}: phase 5's B = 2 line launched {batched_launches}")
        check(r_node.app.height == 3
              and r_node.app.store.app_hashes[r_node.app.store.version].hex() == NODE_APP_HASH_3,
              f"the restarted R at height {r_node.app.height}, app hash "
              f"{r_node.app.store.app_hashes[r_node.app.store.version].hex()}")
        check(2 in r_node.store and 2 not in r_node._dah_cache
              and r_node.block_dah(2).hash().hex() == CHAIN_DAH_HASH
              and json.dumps(r_node.block_dah(2).to_json(), sort_keys=True) == pre_dah,
              "the restarted R's block_dah(2) differs from the stored DAH")
        crowd = serving_crowd(SEED + 20, (2, 3), 2 * PROPOSAL_K, NODE_CROWD)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        docs = r_node.sample_batch_ragged(crowd)
        torch.cuda.synchronize()
        crowd_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_cuda.LAUNCHES)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the restarted R's crowd launched {counts}: ragged_gather once, nothing else")
        st = r_node._eds_cache.stats()
        check(st["heights_from_store"] == 2 and st["page_corrupt"] == 0,
              f"the restarted R's crowd read its heights off disk: {st}")
        for (h, i, j), doc in zip(crowd, docs):
            share = bytes.fromhex(doc["share"])
            prf = doc["proof"]
            NmtRangeProof(prf["start"], prf["end"], [bytes.fromhex(x) for x in prf["nodes"]],
                          prf["tree_size"]).verify_inclusion(
                r_node.block_dah(h).row_roots[i],
                [da.erasured_leaf_namespace(i, j, share, PROPOSAL_K)], [share])

        # state sync from P's snapshot, and a payload with one byte flipped
        payload = p_node.snapshot_payload()
        p_hash = p_node.app.store.app_hashes[p_node.app.store.version]
        t0 = time.perf_counter()
        s_node = Node.state_sync_from(payload, trusted_app_hash=p_hash, device=dev)
        sync_ms = (time.perf_counter() - t0) * 1e3
        check(s_node.app.store.app_hashes[s_node.app.store.version] == p_hash
              and s_node.app.height == 3 and s_node.device.type == "cuda",
              f"the state-synced node at height {s_node.app.height} on {s_node.device}")
        err = raised(lambda: Node.state_sync_from(flip_state_byte(payload),
                                                  trusted_app_hash=p_hash, device=dev))
        check(isinstance(err, ValueError) and "snapshot app hash mismatch" in str(err),
              f"a payload with a flipped state byte: {err!r}")
        clean(p_node, "the node phase")
        med = statistics.median
        emit(phase="node", k=PROPOSAL_K, txs=len(raws), launches=NODE_LAUNCHES,
             load_launches=batched_launches,
             broadcast_tx_ms={"proposer": med(broadcast_ms["p"]),
                              "replica": med(broadcast_ms["r"])},
             produce_block_ms=produce_ms, produce_split_ms=produce_split,
             apply_external_block_ms=apply_ms, apply_split_ms=apply_split,
             height_3_ms={"produce_block": produce3_ms, "apply_external_block": apply3_ms},
             load_ms=load_ms, load_batched_ms=batched[0].duration * 1e3,
             load_replay_blocks=2, crowd_samples=len(crowd), crowd_ms=crowd_ms,
             state_sync_ms=sync_ms, flipped_state=str(err),
             app_hash_2=b2.app_hash.hex(), app_hash_3=b3.app_hash.hex(),
             dah_3=b3.data_hash.hex(), retention_failures=retention_failures(metrics) - failures0,
             phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(home, ignore_errors=True)

def lane_docs(eds: np.ndarray, coords, k: int) -> list:
    """The sample documents of ``coords`` built on the host from a fetched
    EDS (host-hashed provers)."""
    from celestia_tpu_torch import proof

    rows = {i: [eds[i, c].tobytes() for c in range(2 * k)] for i in sorted({i for i, _j in coords})}
    return proof.das_sample_docs(rows, list(coords), k)


def stream_blocks(pipe, squares, first_height: int = 0, keep: bool = True) -> tuple[list, float]:
    """Feed the squares through a BlockPipeline as consecutive heights and
    drain it: (the retired blocks in retirement order, the stream's wall
    seconds, ending when the last block's results are on the host). With
    ``keep`` False each block is dropped as it retires (its height kept)."""
    out = []

    def take(block) -> None:
        if block is not None:
            out.append(block if keep else block.height)

    t = time.perf_counter()
    for h, sq in enumerate(squares, first_height):
        take(pipe.feed(h, sq))
    for block in pipe.drain():
        take(block)
    return out, time.perf_counter() - t


def same_block(block, ref) -> bool:
    """A retired block equals ``ref`` = (eds, row_roots, col_roots, dah,
    levels), byte for byte."""
    eds, rows, cols, dah, levels = ref
    return (np.array_equal(block.eds, eds) and np.array_equal(block.row_roots, rows)
            and np.array_equal(block.col_roots, cols) and np.array_equal(block.dah, dah)
            and len(block.levels) == len(levels)
            and all(np.array_equal(a, b) for a, b in zip(block.levels, levels)))


def crowd_through(dispatcher, exec_fn, payloads, threads: int) -> list:
    """The crowd as batch jobs under the ``("sample",)`` key, from
    ``threads`` request threads, each submitting its share of the payloads
    one job at a time, as a server's request threads do: the documents in
    the crowd's order."""
    import concurrent.futures

    def worker(t: int) -> list:
        return [(i, dispatcher.submit(label="sample", batch_key=("sample",),
                                      batch_exec=exec_fn, payload=payloads[i]))
                for i in range(t, len(payloads), threads)]

    out = [None] * len(payloads)
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for part in pool.map(worker, range(threads)):
            for i, doc in part:
                out[i] = doc
    return out


def lane_phase(dev, emit, squares: list, crowd: list, codec_squares: dict,
               codec_masks: dict) -> None:
    """Phase 6h: the device lane on the card (see the module docstring).
    ``squares``: bench.py's square at k = 128, seeds 42-47 (the first four
    are phase 6b's heights 1-4); ``crowd``: phase 6b's 256-sample crowd over
    those heights; ``codec_squares`` and ``codec_masks``: the codec's square
    and 25% presence mask per k. Every check raises; nothing is caught."""
    import concurrent.futures
    import gc
    import shutil
    import tempfile

    import torch

    from celestia_tpu_torch import da, devledger, faults, tracing
    from celestia_tpu_torch.appconsts import SHARE_SIZE
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.dispatch import DeadlineExceeded, DeviceDispatcher, Shed
    from celestia_tpu_torch.node.pipeline import HOST_POOL, BlockPipeline
    from celestia_tpu_torch.ops import _cuda, extend, transfers
    from celestia_tpu_torch.ops.repair import plan_sweeps
    from celestia_tpu_torch.service import codec_service, wire
    from celestia_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    k = squares[0].shape[0]
    n = len(squares)
    zero = dict.fromkeys(_cuda.LAUNCHES, 0)

    def counted(call):
        """call() with the launch counts from 0: (its result, the counts)."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = call()
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES)

    def settled_ledger() -> dict:
        gc.collect()
        torch.cuda.synchronize()
        return devledger.ledger.snapshot()

    # (a) the serial entries' bytes: the reference every pipelined block is held to
    t = time.perf_counter()
    refs = []
    for sq in squares:
        eds, rows, cols, dah = extend.extend_and_root_device(sq, dev)
        refs.append((eds, rows, cols, dah, extend.eds_row_levels_device(eds, dev)))
    entries_s = time.perf_counter() - t

    # (b) six squares through a bare 3-deep pipeline, the launches counted
    pipe = BlockPipeline(k, depth=3, device=dev)
    (blocks, stream_s), counts = counted(lambda: stream_blocks(pipe, squares))
    want = {**zero, **{name: c * n for name, c in PIPELINE_LAUNCHES.items()}}
    emit(phase="main_path", entry="BlockPipeline.feed", k=k, blocks=n, depth=3, launches=counts)
    check(counts == want, f"the pipeline launched {counts}: {want} expected")
    check([b.height for b in blocks] == list(range(n)),
          f"retire order {[b.height for b in blocks]}")
    check(all(same_block(b, refs[b.height]) for b in blocks),
          "a pipelined block differs from extend_and_root_device and eds_row_levels_device")
    # three pinned result sets in turn; every retired array is pageable, none
    # a view of a set
    ring = [hosts for hosts, _fetched in filter(None, pipe._ring)]
    check(len(ring) == 3 and not any(np.shares_memory(a, h.numpy()) for b in blocks
                                     for a in (b.eds, *b.levels) for hosts in ring
                                     for h in hosts),
          f"the pipeline's ring holds {len(ring)} pinned sets, or a block is a view of one")
    stage_wall = pipe.stats()["stage_wall_s"]
    check(pipe.stats()["fed"] == pipe.stats()["retired"] == n and pipe.inflight == 0
          and pipe.device_bytes() == 0, f"the pipeline after drain: {pipe.stats()}")
    shed = raised(lambda: pipe.feed(n, squares[0]))
    check(isinstance(shed, Shed) and shed.reason == "draining",
          f"feed after drain raised {shed!r}, not Shed('draining')")
    del blocks
    # the stream's time, the blocks dropped as they retire, in turns with
    # the same work fenced: depth 1 retires every block inside its own feed
    timed = {3: [], 1: []}
    walls = {}
    pool0 = (HOST_POOL.fresh, HOST_POOL.reused)
    for depth in (3, 1) * 5:
        timed_pipe = BlockPipeline(k, depth=depth, device=dev)
        order, wall = stream_blocks(timed_pipe, squares, keep=False)
        check(order == list(range(n)), f"depth {depth}: retire order {order}")
        timed[depth].append(wall)
        walls[depth] = timed_pipe.stats()["stage_wall_s"]
    host_pool = {"fresh": HOST_POOL.fresh - pool0[0], "reused": HOST_POOL.reused - pool0[1]}
    check(host_pool["reused"] > 0, f"the dropped blocks' host buffers were never reused: {host_pool}")
    serial_blocks, _wall = stream_blocks(BlockPipeline(k, depth=1, device=dev), squares)
    check(all(same_block(b, refs[b.height]) for b in serial_blocks),
          "a depth-1 block differs from the serial entries")
    del serial_blocks

    # one block's three legs back to back on the card, by CUDA events: the
    # square's H2D from pinned memory, the compute leg's launches, the D2H
    # of its results into pinned memory (median of 3)
    legs_ms: dict[str, list[float]] = {"h2d": [], "compute": [], "d2h": []}
    src = torch.from_numpy(squares[0]).pin_memory()
    for _ in range(3):
        x = torch.empty(src.shape, dtype=torch.uint8, device=dev)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        marks[0].record()
        x.copy_(src, non_blocking=True)
        marks[1].record()
        outs = extend.extend_root_levels_staged(x)
        marks[2].record()
        results = [*outs[:4], *outs[4]]
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in results]
        torch.cuda.synchronize()  # the allocations stay out of the timed D2H
        marks[3].record()
        for h, r in zip(hosts, results):
            h.copy_(r, non_blocking=True)
        marks[4].record()
        marks[4].synchronize()
        for name, (a, b) in zip(legs_ms, ((0, 1), (1, 2), (3, 4))):
            legs_ms[name].append(marks[a].elapsed_time(marks[b]))
    block_device_ms = {name: statistics.median(v) for name, v in legs_ms.items()}
    del x, outs, results, hosts

    # (c) the ledger: warm-up ends after the first streams; a second stream
    # under strict retraces builds nothing new and leaves no device bytes
    before = settled_ledger()
    devledger.end_warmup()
    with devledger.ledger.strict_retraces():
        again, again_s = stream_blocks(BlockPipeline(k, depth=3, device=dev), squares)
    after = settled_ledger()
    check(devledger.ledger.retrace_count() == 0, f"retraces: {devledger.ledger.retraces()}")
    check(all(same_block(b, refs[b.height]) for b in again), "the second stream's bytes differ")
    check(after["unattributed_bytes"] <= before["unattributed_bytes"],
          f"unattributed device bytes grew from {before['unattributed_bytes']} to "
          f"{after['unattributed_bytes']} over a second stream")
    doc = devledger.debug_doc()
    devledger.begin_warmup()
    emit(phase="lane", part="pipeline", k=k, blocks=n, depth=3, first_stream_s=stream_s,
         first_stage_wall_s=stage_wall, kept_stream_s=again_s, stream_s=timed[3],
         serial_depth1_s=timed[1], stage_wall_s=walls[3], serial_stage_wall_s=walls[1],
         serial_entries_s=entries_s, block_device_ms=block_device_ms, host_pool=host_pool)
    emit(phase="lane", part="ledger", owners=doc["ledger"]["owners"],
         live_bytes=doc["ledger"]["live_bytes"],
         attributed_bytes=doc["ledger"]["attributed_bytes"],
         unattributed_bytes=doc["ledger"]["unattributed_bytes"],
         unattributed_before=before["unattributed_bytes"],
         unattributed_after=after["unattributed_bytes"],
         builds={e: v["builds"] for e, v in doc["compile"]["entries"].items()},
         retrace_count=doc["compile"]["retrace_count"], provenance=doc["provenance"])

    # (d) three squares through Node.extend_pipeline on a node with a home:
    # the DAH memo, reads from the cache with provers from the levels (no
    # launch), and the store's records
    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-lane-"))
    try:
        pnode = Node(device=dev, home=home)
        npipe = pnode.extend_pipeline(k)
        (nblocks, node_s), counts = counted(
            lambda: stream_blocks(npipe, squares[:LANE_NODE_BLOCKS], first_height=1))
        want = {**zero, **{name: c * LANE_NODE_BLOCKS for name, c in PIPELINE_LAUNCHES.items()}}
        emit(phase="main_path", entry="Node.extend_pipeline", k=k, blocks=LANE_NODE_BLOCKS,
             launches=counts)
        check(counts == want, f"Node.extend_pipeline launched {counts}: {want} expected")
        coords = [(i, j) for _h, i, j in serving_crowd(SEED + 70, (1,), 2 * k, 32)]
        read_counts = {}
        for h in range(1, LANE_NODE_BLOCKS + 1):
            eds, rows, cols, dah, levels = refs[h - 1]
            check(pnode.block_dah(h).hash() == dah.tobytes()
                  and pnode.block_dah(h).row_roots == [r.tobytes() for r in rows],
                  f"height {h}: the adopted DAH memo differs")
            docs, read_counts[h] = counted(lambda: pnode.sample_batch(h, coords))
            check(read_counts[h] == zero and pnode._prover_cache[h][0] is not None,
                  f"height {h}: the reads launched {read_counts[h]}: provers from the levels expected")
            check(docs == lane_docs(eds, coords, k), f"height {h}: the cache's documents differ")
            check(da.DataAvailabilityHeader.from_json(pnode.store.read_dah(h)).hash()
                  == dah.tobytes(), f"height {h}: the store's DAH differs")
            stored = pnode.store.read_levels(h)
            check(len(stored) == len(levels)
                  and all(np.array_equal(a, b) for a, b in zip(stored, levels)),
                  f"height {h}: the store's levels differ")
            page, _crc = pnode.store.read_page(h, 0)
            check(np.array_equal(page, eds[:page.shape[0]]), f"height {h}: the store's page 0 differs")
    finally:
        shutil.rmtree(home, ignore_errors=True)
    # the node's own stream, as a replica without a home adopts it (the DAH
    # memo, the cache, the provers' levels; the store's persist left out),
    # at depth 3 in turns with depth 1
    adopted = {3: [], 1: []}
    for depth in (3, 1) * 3:
        tnode = Node(device=dev)
        order, wall = stream_blocks(tnode.extend_pipeline(k, depth=depth), squares,
                                    first_height=1, keep=False)
        check(order == list(range(1, n + 1)) and tnode.block_dah(n).hash() == refs[-1][3].tobytes(),
              f"the node's depth-{depth} stream: retire order {order}, or its last DAH differs")
        adopted[depth].append(wall)
        del tnode
    emit(phase="lane", part="node_pipeline", k=k, blocks=LANE_NODE_BLOCKS, stream_s=node_s,
         stage_wall_s=npipe.stats()["stage_wall_s"], sample_reads=len(coords),
         adopted_blocks=n, adopted_stream_s=adopted[3], adopted_serial_depth1_s=adopted[1])

    # (e) the dispatcher attached, as a server attaches it, to a node with
    # phase 6b's four heights (6b's own node has read its squares to the
    # host, so its reads no longer gather); the crowd from eight request
    # threads as ("sample",) batch jobs
    node = Node(device=dev)
    for h in sorted({h for h, _i, _j in crowd}):
        node._eds_cache.put(h, da.extend_shares(squares[h - 1].reshape(-1, SHARE_SIZE), dev))
    direct = node.sample_batch_ragged(crowd)
    disp = DeviceDispatcher().start()
    node.dispatcher = disp
    transfers.register_device_executor(disp.run_device)
    try:
        batches0 = metrics.get_counter("dispatch_batch_total")
        jobs0 = metrics.get_counter("dispatch_batched_jobs_total")
        t = time.perf_counter()
        docs, counts = counted(lambda: crowd_through(disp, node.sample_batch_ragged, crowd,
                                                     LANE_THREADS))
        crowd_s = time.perf_counter() - t
        busy = devledger.ledger.busy_ratio()
        batches = metrics.get_counter("dispatch_batch_total") - batches0
        jobs = metrics.get_counter("dispatch_batched_jobs_total") - jobs0
        # the six squares through Node.extend_pipeline with the dispatcher
        # attached: the pipeline's legs run on the dispatcher's thread,
        # under the compute stream this thread made the pipeline on
        dnode = Node(device=dev)
        dnode.dispatcher = disp
        dpipe = dnode.extend_pipeline(k)
        check(dpipe.dispatcher is disp, "Node.extend_pipeline did not take the node's dispatcher")
        with tracing.record() as rec:
            (dblocks, dispatched_s), dcounts = counted(lambda: stream_blocks(dpipe, squares))
        legs = [sp for sp in rec.spans if sp.name == "dispatch.run"
                and str(sp.attrs.get("label", "")).startswith("pipeline.")]
        dispatched_legs = len(legs)
        leg_threads = {sp.tid for sp in legs}
        disp_thread = disp._thread.ident
    finally:
        transfers.unregister_device_executor(disp.run_device)
        node.dispatcher = None
        clean_drain = disp.drain()
    emit(phase="main_path", entry="DeviceDispatcher.submit", batch_key="sample",
         samples=len(crowd), launches=counts)
    check(docs == direct, "the dispatcher's documents differ from sample_batch_ragged's")
    check(jobs == len(crowd) and batches >= 1 and counts["ragged_gather"] == batches
          and sum(counts.values()) == batches,
          f"{jobs} jobs in {batches} batches launched {counts}: one ragged_gather a batch")
    check(busy > 0 and clean_drain, f"busy ratio {busy}, clean drain {clean_drain}")
    want = {**zero, **{name: c * n for name, c in PIPELINE_LAUNCHES.items()}}
    emit(phase="main_path", entry="Node.extend_pipeline", dispatcher=True, k=k, blocks=n,
         launches=dcounts)
    check(dcounts == want, f"the dispatched pipeline launched {dcounts}: {want} expected")
    check([b.height for b in dblocks] == list(range(n))
          and all(same_block(b, refs[b.height]) for b in dblocks),
          "a block of the dispatched pipeline differs from the serial entries, or its order")
    check(all(dnode.block_dah(h).hash() == refs[h][3].tobytes() for h in range(n)),
          "the dispatched pipeline's adopted DAH memo differs")
    check(dispatched_legs == 3 * n and leg_threads == {disp_thread},
          f"{dispatched_legs} pipeline legs ran on threads {leg_threads}: {3 * n} on the "
          f"dispatcher's ({disp_thread}) expected")
    del dblocks, dnode
    devledger.publish()
    emit(phase="lane", part="dispatcher", samples=len(crowd), threads=LANE_THREADS,
         batches=batches, jobs_per_batch=jobs / batches, ragged_gather=counts["ragged_gather"],
         device_busy_ratio=metrics.get_gauge("device_busy_ratio"), crowd_s=crowd_s,
         max_batch=disp.max_batch, batch_window_s=disp.batch_window_s,
         pipeline_blocks=n, pipeline_legs=dispatched_legs, pipeline_stream_s=dispatched_s,
         pipeline_stage_wall_s=dpipe.stats()["stage_wall_s"])

    # one queue_full shed and one deadline expiry: a dispatch.run delay
    # stalls the single consumer on its first job
    stalled = DeviceDispatcher(capacity=1).start()
    shed0 = {r: metrics.get_counter("rpc_shed_total", reason=r) for r in ("queue_full", "deadline")}

    def job():
        return int(torch.ones(1, device=dev).sum().item())

    def wait_for(cond, what: str) -> None:
        end = time.monotonic() + 10.0
        while not cond() and time.monotonic() < end:
            time.sleep(0.002)
        check(cond(), f"the stalled dispatcher never reached: {what}")

    with faults.inject(faults.rule("dispatch.run", "delay", delay_s=1.0, times=1), seed=SEED), \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        first = pool.submit(stalled.submit, job)
        wait_for(lambda: stalled._busy and stalled.depth == 0, "the first job taken")
        late = pool.submit(raised, lambda: stalled.submit(job, deadline_s=0.2))
        wait_for(lambda: stalled.depth == 1, "the second job queued")
        full = raised(lambda: stalled.submit(job))
        expired = late.result(timeout=10)
        check(first.result(timeout=10) == 1, "the stalled job's result")
    check(stalled.drain(), "the stalled dispatcher did not drain")
    shed = {r: metrics.get_counter("rpc_shed_total", reason=r) - shed0[r] for r in shed0}
    check(isinstance(full, Shed) and full.reason == "queue_full"
          and isinstance(expired, DeadlineExceeded) and shed == {"queue_full": 1, "deadline": 1},
          f"shed {full!r}, deadline {expired!r}, counted {shed}")
    emit(phase="lane", part="dispatcher_drill", queue_full=type(full).__name__,
         deadline=type(expired).__name__, shed_counted=shed)

    # (f) the codec service's four calls at k = 32 and 128 through its
    # method bodies, marshalled bytes in and out, against the host backend
    gpu, host = codec_service.CodecBackend(), codec_service.CodecBackend(device="cpu")
    check(gpu.use_gpu and not host.use_gpu, "the codec backends' devices")
    codec = {}

    def fallbacks() -> float:
        return sum(metrics.get_counter("codec_gpu_fallback_total", op=op)
                   for op in ("encode", "extend_and_root", "repair"))

    fallbacks0 = fallbacks()
    for kk in CODEC_KS:
        sq, present = codec_squares[kk], codec_masks[kk]
        eds_np = np.frombuffer(host.encode(kk, SHARE_SIZE, sq.tobytes()),
                               np.uint8).reshape(2 * kk, 2 * kk, SHARE_SIZE)
        erased = eds_np.copy()
        erased[~present] = 0
        requests = {
            "Encode": wire.EncodeRequest(kk, SHARE_SIZE, sq.tobytes()),
            "ExtendAndRoot": wire.EncodeRequest(kk, SHARE_SIZE, sq.tobytes()),
            "Roots": wire.EdsRequest(kk, SHARE_SIZE, eds_np.tobytes()),
            "Repair": wire.RepairRequest(kk, SHARE_SIZE, erased.tobytes(),
                                         present.astype(np.uint8).tobytes()),
        }
        launches_of = {"Encode": CODEC_EXTEND_LAUNCHES, "ExtendAndRoot": CODEC_EXTEND_LAUNCHES,
                       "Roots": {}, "Repair": {"decode_sweep": len(plan_sweeps(present, kk))}}
        rung, answers = {}, {}
        for method, req in requests.items():
            raw = req.marshal()
            codec_service.call_in_process(gpu, method, raw)  # warm
            t = time.perf_counter()
            answers[method], counts = counted(
                lambda: codec_service.call_in_process(gpu, method, raw))
            ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            want_bytes = codec_service.call_in_process(host, method, raw)
            host_ms = (time.perf_counter() - t) * 1e3
            check(answers[method] == want_bytes,
                  f"k={kk}: {method} on the card differs from the host backend")
            check(counts == {**zero, **launches_of[method]},
                  f"k={kk}: {method} launched {counts}: {launches_of[method]} expected")
            rung[method] = {"ms": ms, "host_ms": host_ms,
                            "launches": {name: c for name, c in counts.items() if c}}
        check(wire.EdsResponse.unmarshal(answers["Encode"]).eds == eds_np.tobytes()
              and wire.EdsResponse.unmarshal(answers["Repair"]).eds == eds_np.tobytes(),
              f"k={kk}: Encode or Repair did not give the extended square")
        codec[kk] = rung
    check(gpu.use_gpu and gpu._gpu_strikes == 0
          and fallbacks() == fallbacks0,
          "the codec's card path degraded")
    loopback = None
    if importlib.util.find_spec("grpc") is not None:
        server = codec_service.CodecServer()
        server.start()
        client = codec_service.CodecClient(f"127.0.0.1:{server.port}", timeout=60.0)
        try:
            sq = codec_squares[CODEC_KS[-1]]
            want_roots = codec_service.CodecBackend(device="cpu").extend_and_root(
                sq.shape[0], SHARE_SIZE, sq.tobytes())
            client.extend_and_root(sq)  # warm
            t = time.perf_counter()
            got_roots = client.extend_and_root(sq)
            loopback = {"method": "ExtendAndRoot", "k": sq.shape[0],
                        "ms": (time.perf_counter() - t) * 1e3}
            check(tuple(got_roots) == tuple(want_roots), "the loopback client's roots differ")
        finally:
            client.close()
            server.stop()
    emit(phase="lane", part="codec", ks=list(CODEC_KS), calls=codec,
         transport="grpc loopback" if loopback else "in process (no grpc)", loopback=loopback,
         phase_seconds=time.perf_counter() - t_phase)


RPC_THREADS = 8  # request threads of the crowd over HTTP
RPC_LC_SAMPLES = 16  # the light client's samples of the k = 128 block
RPC_PROBE_CYCLES = 3
RPC_TIMED = 5  # GET /dah repeats (median); /eds is fetched twice
RPC_CLI_BLOCK_TIME = 0.5  # the CLI node's goal block time, seconds
RPC_CLI_WAIT_S = 120.0  # the longest wait for a line of the CLI node
RPC_CLI_PFB_BYTES = 100_000  # the CLI node's PFB: about 210 shares, k = 16
RPC_PROOF_TX = 7  # the tx of height 2 whose inclusion proof 6j fetches


def http_get(base: str, path: str, timeout: float = 120.0) -> tuple[int, bytes]:
    """(status, raw body) of one GET; an HTTP error status is an answer."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_crowd(base: str, payloads, threads: int) -> list:
    """The crowd as GET /sample/<h>/<i>/<j> requests from ``threads``
    request threads, each sending its share one request at a time, as
    light clients do: (status, parsed body) in the crowd's order."""
    import concurrent.futures

    def worker(t: int) -> list:
        out = []
        for n in range(t, len(payloads), threads):
            h, i, j = payloads[n]
            status, body = http_get(base, f"/sample/{h}/{i}/{j}")
            out.append((n, (status, json.loads(body))))
        return out

    docs = [None] * len(payloads)
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for part in pool.map(worker, range(threads)):
            for n, doc in part:
                docs[n] = doc
    return docs


def prometheus_series(text: str) -> dict[str, list[float]]:
    """The series of a Prometheus text export (format v0.0.4), by name:
    every sample line's family announced by a TYPE line before it, every
    value a number; other comment lines (HELP, exemplars) are skipped. Any
    other line fails the check."""
    series: dict[str, list[float]] = {}
    typed: set[str] = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            check(kind in ("counter", "gauge", "histogram"), f"/metrics: {line!r}")
            typed.add(name)
            continue
        if line.startswith("#"):
            continue
        m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                         r'([-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|inf|nan))', line, re.I)
        check(m is not None, f"/metrics: a malformed line {line!r}")
        name = m.group(1)
        family = name if name in typed else re.sub(r"_(bucket|sum|count)$", "", name)
        check(family in typed, f"/metrics: {name} has no TYPE line")
        series.setdefault(name, []).append(float(m.group(3)))
    return series


def chain_send(key, to: str, sequence: int) -> bytes:
    """A MsgSend of APP_SEND from ``key`` (account 0) at ``sequence``."""
    from celestia_tpu_torch.tx import Fee, sign_tx
    from celestia_tpu_torch.x.bank import MsgSend

    return sign_tx(key, [MsgSend(key.bech32_address(), to, APP_SEND)], CHAIN_ID, 0, sequence,
                   Fee(amount=4_000, gas_limit=400_000)).marshal()


class LineReader:
    """A subprocess's stdout lines through a reader thread, so a wait for
    the next line has a time limit."""

    def __init__(self, stream):
        import queue
        import threading

        self._lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []

        def pump() -> None:
            for line in stream:
                self._lines.put(line)
            self._lines.put(None)

        threading.Thread(target=pump, daemon=True).start()

    def until(self, pattern: str, timeout: float = RPC_CLI_WAIT_S):
        """The first match of ``pattern`` in a line yet to come."""
        import queue

        end = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                line = None
            check(line is not None, f"the CLI node printed no line matching {pattern!r}: "
                  f"{self.seen[-5:]}")
            self.seen.append(line)
            m = re.search(pattern, line)
            if m:
                return m


def cli_out(argv: list[str]) -> tuple[int, str]:
    """``python -m celestia_tpu_torch.cli`` run in this process: (exit code,
    stdout)."""
    import contextlib
    import io

    from celestia_tpu_torch import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def rpc_phase(dev, emit, signer_key, raws: list[bytes], squares: list, crowd: list) -> None:
    """Phase 6j: the network surface on the card (see the module
    docstring). ``raws``: config 8b's 60 signed PFBs; ``squares``: phase
    6b's four k = 128 squares (heights 1-4); ``crowd``: 6b's 256-sample
    crowd over them. Every check raises; nothing is caught."""
    import random
    import shutil
    import signal
    import tempfile

    import torch

    from celestia_tpu_torch import crypto, da, tracing
    from celestia_tpu_torch import namespace as ns_mod
    from celestia_tpu_torch.appconsts import SHARE_SIZE
    from celestia_tpu_torch.app.app import GPU_MIN_SQUARE, App
    from celestia_tpu_torch.da import fraud
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.client import FraudAwareLightClient, FraudDetected, RpcClient
    from celestia_tpu_torch.node.node import Block
    from celestia_tpu_torch.node.prober import Prober
    from celestia_tpu_torch.node.rpc import RpcServer, namespace_data_doc, tx_proof_doc
    from celestia_tpu_torch.ops import _cuda, transfers
    from celestia_tpu_torch.telemetry import Registry, metrics
    from celestia_tpu_torch.testutil.malicious import BehaviorConfig, MaliciousApp

    t_phase = time.perf_counter()
    med = statistics.median
    v_key = crypto.PrivateKey.from_secret(APP_VALIDATOR_SECRET)
    s_addr, v_addr = signer_key.bech32_address(), v_key.bech32_address()
    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-rpc-"))
    servers: list = []
    proc = None

    def serve(node) -> str:
        srv = RpcServer(node, port=0)
        srv.start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.port}"

    def counted(call):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, dict(_cuda.LAUNCHES)

    try:
        # (3) first: 6b's crowd over HTTP against the same node's in-process
        # answer, C's server the only one, so that its dispatcher is the
        # process's device executor, as a node's is
        c_node = Node(device=dev)
        for h in sorted({h for h, _i, _j in crowd}):
            c_node._eds_cache.put(h, da.extend_shares(squares[h - 1].reshape(-1, SHARE_SIZE),
                                                      dev))
        direct = c_node.sample_batch_ragged(crowd)  # seeds each height's provers
        again, direct_ms, _counts = counted(lambda: c_node.sample_batch_ragged(crowd))
        check(again == direct, "a second in-process crowd's documents differ")
        c_url = serve(c_node)
        c_srv = servers[-1]
        check(transfers._device_executor() == c_srv.dispatcher.run_device,
              "C's dispatcher is not the process's device executor")
        # a batch gathers once, unless every row it needs is already in its
        # heights' row memos (the cache's last 8 rows a height): record
        # which batches had a row to gather, as each reaches the cache
        needs = []
        real_pages_batch = c_node._eds_cache.pages_batch

        def pages_batch(wants):
            needs.append(any(paged._memo_get(i) is None for paged, i in wants))
            return real_pages_batch(wants)

        c_node._eds_cache.pages_batch = pages_batch
        batches0 = metrics.get_counter("dispatch_batch_total")
        docs, crowd_ms, crowd_counts = counted(lambda: http_crowd(c_url, crowd, RPC_THREADS))
        batches = metrics.get_counter("dispatch_batch_total") - batches0
        c_node._eds_cache.pages_batch = real_pages_batch
        emit(phase="main_path", entry="RpcServer /sample", samples=len(crowd),
             threads=RPC_THREADS, batches=batches, memo_only_batches=needs.count(False),
             launches=crowd_counts)
        check(all(status == 200 for status, _d in docs) and [d for _s, d in docs] == direct,
              "the crowd's documents over HTTP differ from sample_batch_ragged's")
        check(batches >= 1 and len(needs) == batches
              and crowd_counts["ragged_gather"] == needs.count(True)
              and sum(crowd_counts.values()) == crowd_counts["ragged_gather"],
              f"{len(crowd)} samples over HTTP in {batches} batches ({needs.count(False)} with "
              f"every row in the row memos) launched {crowd_counts}: one ragged_gather a batch "
              "with a row to gather")
        # the same crowd in process from this thread: its gather funnels
        # through the dispatcher, one internal dispatch.run a gather
        with tracing.record() as rec:
            funneled, _ms, f_counts = counted(lambda: c_node.sample_batch_ragged(crowd))
        funnel_runs = sum(1 for sp in rec.spans
                          if sp.name == "dispatch.run" and sp.attrs.get("internal"))
        check(funneled == direct and f_counts["ragged_gather"] >= 1
              and funnel_runs == f_counts["ragged_gather"],
              f"the in-process crowd beside C's server launched {f_counts} in {funnel_runs} "
              "internal dispatcher runs: one a gather")
        c_srv.stop()
        servers.remove(c_srv)

        # (1) blocks through the RPC: P (a proposer with a blob arena) and R
        # (a replica), each behind its server
        nodes = {}
        for name in ("p", "r"):
            app = App(chain_id=CHAIN_ID, device=dev)
            if name == "p":
                app.enable_blob_pool()
            app_genesis(app, s_addr, v_addr)
            nodes[name] = Node(app, home=home / name, extend_blocks=True)
        p_node, r_node = nodes["p"], nodes["r"]
        p_url, r_url = serve(p_node), serve(r_node)
        p_rpc, r_rpc = RpcClient(p_url, timeout=120.0), RpcClient(r_url, timeout=120.0)

        def produce_over_rpc(expected_height: int):
            doc, ms, counts = counted(lambda: p_rpc._post("/produce_block", {}))
            check("error" not in doc and doc["height"] == expected_height,
                  f"POST /produce_block: {str(doc)[:300]}")
            block = Block.from_json(doc)
            r_node.apply_external_block(block.txs, block.square_size, block.data_hash,
                                        block.time, expected_height=expected_height)
            return block, ms, counts

        produce_over_rpc(1)
        broadcast_ms = []
        for raw in raws:
            t = time.perf_counter()
            res = p_rpc.broadcast_tx(raw)
            broadcast_ms.append((time.perf_counter() - t) * 1e3)
            check(res.code == 0, f"P refused a signed PFB over the RPC: {res.log}")
            check(r_node.broadcast_tx(raw).code == 0, "R refused a signed PFB")
        b2, produce_http_ms, counts = produce_over_rpc(2)
        emit(phase="main_path", entry="RpcServer POST /produce_block", k=b2.square_size,
             txs=len(b2.txs), launches=counts)
        want = {**dict.fromkeys(counts, 0), **NODE_LAUNCHES["produce_block"]}
        check(counts == want, f"POST /produce_block launched {counts}: {want} expected")
        check(b2.txs == raws and b2.square_size == PROPOSAL_K
              and b2.data_hash.hex() == CHAIN_DAH_HASH,
              f"the RPC's height 2: {len(b2.txs)} txs at k = {b2.square_size}, data hash "
              f"{b2.data_hash.hex()}")
        dahs = {}
        for name, client in (("p", p_rpc), ("r", r_rpc)):
            dahs[name] = da.DataAvailabilityHeader.from_json(client.dah(2))
            check(dahs[name].hash().hex() == CHAIN_DAH_HASH,
                  f"{name}'s GET /dah/2 hashes to {dahs[name].hash().hex()}")
        check(r_rpc.header(2) == p_rpc.header(2), "R's /header/2 differs from P's")
        # /proof/tx and /namespace_data of a namespace no blob has: squares
        # extended on the dispatcher's thread, P's and R's documents equal to
        # the in-process ones
        p_block = p_node.get_block(2)
        absent = ns_mod.new_v0(b"arena" + (PROPOSAL_BLOBS + 1).to_bytes(5, "big"))
        ns_doc, ns_status = namespace_data_doc(p_node, p_block, absent)
        check(ns_status == 200 and ns_doc["ranges"] == [] and "absence" in ns_doc,
              f"namespace_data_doc of an absent namespace: {ns_status} {str(ns_doc)[:300]}")
        proof_docs = {f"/proof/tx/2:{RPC_PROOF_TX}": tx_proof_doc(p_node, p_block, RPC_PROOF_TX),
                      f"/namespace_data/2/{absent.bytes.hex()}": ns_doc}
        proof_ms = {}
        for path, want_doc in proof_docs.items():
            want_doc = json.loads(json.dumps(want_doc))
            for url in (p_url, r_url):
                t = time.perf_counter()
                status, body = http_get(url, path)
                proof_ms.setdefault(path.split("/")[1], []).append(
                    (time.perf_counter() - t) * 1e3)
                check(status == 200 and json.loads(body) == want_doc,
                      f"GET {path} from {url}: {status} {body[:300]}")
        dah_ms = []
        for _ in range(RPC_TIMED):
            t = time.perf_counter()
            status, _body = http_get(p_url, "/dah/2")
            dah_ms.append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"GET /dah/2: {status}")
        eds_ms = []
        for _ in range(2):
            t = time.perf_counter()
            doc = p_rpc.eds(2)
            eds_ms.append((time.perf_counter() - t) * 1e3)
        eds_host = np.stack([np.frombuffer(bytes.fromhex(r), np.uint8).reshape(-1, SHARE_SIZE)
                             for r in doc["rows"]])
        check(da.ExtendedDataSquare(eds_host, PROPOSAL_K, dev).row_roots() == dahs["p"].row_roots,
              "GET /eds/2's rows do not hash to the DAH's roots")
        del doc, eds_host
        # the same kind of block in process: 60 more PFBs, Node.produce_block
        for raw in node_height3_txs(signer_key):
            check(p_rpc.broadcast_tx(raw).code == 0, "P refused a height-3 PFB")
        b3, produce_ms, counts = counted(lambda: p_node.produce_block())
        check(b3.height == 3 and b3.square_size == PROPOSAL_K
              and b3.data_hash.hex() == NODE_DAH_HASH_3 and counts == want,
              f"Node.produce_block at height 3: k = {b3.square_size}, "
              f"{b3.data_hash.hex()}, launched {counts}")

        # (2) the fraud-aware light client over both servers, then against a
        # MaliciousApp node whose bad encoding a read-only node proved
        lc = FraudAwareLightClient([RpcClient(p_url), RpcClient(r_url)], [RpcClient(r_url)])
        check(lc.accept_header(1)["height"] == 1
              and lc.accept_header(2)["data_hash"] == CHAIN_DAH_HASH,
              "the light client refused an honest header")
        lc.rescreen()
        das = lc.sample_availability(2, n=RPC_LC_SAMPLES, rng=random.Random(SEED))
        check(das["sampled"] == RPC_LC_SAMPLES, f"the light client's samples: {das}")
        m_app = MaliciousApp(chain_id=CHAIN_ID, device=dev,
                             behavior=BehaviorConfig(corrupt_extension=True))
        app_genesis(m_app, s_addr, v_addr)
        m_node = Node(m_app)
        m_node.produce_block(APP_BLOCK_TIMES[0])
        check(m_node.broadcast_tx(raws[0]).code == 0, "the attacker refused a PFB")
        m_block = m_node.produce_block(APP_BLOCK_TIMES[1])
        w_node = Node(device=dev)
        m_url, w_url = serve(m_node), serve(w_node)
        served = RpcClient(m_url).eds(2)
        m_eds = np.stack([np.frombuffer(bytes.fromhex(r), np.uint8).reshape(-1, SHARE_SIZE)
                          for r in served["rows"]])
        m_dah = da.DataAvailabilityHeader.from_json(RpcClient(m_url).dah(2))
        befp = fraud.find_befp(m_eds)
        check(m_dah.hash() == m_block.data_hash and befp is not None
              and fraud.verify_befp(befp, m_dah), "no verified BEFP of the attacker's square")
        check(w_node.add_fraud_proof(2, m_dah.hash(), {"height": 2, "dah": m_dah.to_json(),
                                                       "proof": befp.to_json()}),
              "the watchtower refused the proof")
        m_lc = FraudAwareLightClient(RpcClient(m_url), [RpcClient(w_url)])
        check(m_lc.accept_header(1)["height"] == 1, "the attacker's height 1 was refused")
        fraud_err = raised(lambda: m_lc.accept_header(2))
        check(isinstance(fraud_err, FraudDetected) and 2 not in m_lc.headers,
              f"the attacker's height 2: {fraud_err!r}, not FraudDetected")

        # (4) the prober through P's server: share proofs and the host crosscheck
        prober = Prober(p_url, samples_per_cycle=8, timeout=120.0, host_crosscheck=True,
                        rng=random.Random(SEED), registry=Registry())
        t = time.perf_counter()
        cycles = [prober.probe_cycle() for _ in range(RPC_PROBE_CYCLES)]
        probe_s = time.perf_counter() - t
        check(all(c["ok"] and c["height"] == 3 and c["share_proof_ok"] == 1
                  and c["crosscheck_ok"] == 1 for c in cycles),
              f"the prober's cycles: {cycles}")

        # (6) /metrics, with the request stages traced
        tracing.enable()
        try:
            check(http_get(p_url, "/dah/2")[0] == 200, "a traced GET /dah/2")
            status, text = http_get(p_url, "/metrics")
        finally:
            tracing.disable()
        series = prometheus_series(text.decode())
        check(status == 200 and series.get("rpc_stage_ms_seconds_count")
              and series.get("process_rss_bytes", [0])[0] > 0,
              f"/metrics: {status}, {sorted(series)[:20]}")

        # (7) gRPC, where grpc imports
        grpc_doc = None
        if importlib.util.find_spec("grpc") is not None:
            from celestia_tpu_torch.node.grpc_api import GrpcClient, NodeGrpcServer

            g_server = NodeGrpcServer(p_node)
            g_server.start()
            g_client = GrpcClient(f"127.0.0.1:{g_server.port}", timeout=60.0)
            try:
                g_status = g_client.status()
                g_res = g_client.broadcast_tx(chain_send(signer_key, v_addr, 2 * PROPOSAL_BLOBS))
            finally:
                g_client.close()
                g_server.stop()
            check(g_status["height"] == 3 and g_status["chain_id"] == CHAIN_ID
                  and g_res.code == 0, f"gRPC: status {g_status}, broadcast {g_res}")
            grpc_doc = {"status_height": g_status["height"], "broadcast_code": g_res.code}

        # (5) readiness, then the drain
        status, body = http_get(p_url, "/readyz")
        check(status == 200 and json.loads(body)["ready"], f"P's /readyz: {status} {body[:300]}")
        servers[0].dispatcher.begin_drain()
        status, body = http_get(p_url, "/readyz")
        checks = {c["name"]: c["ok"] for c in json.loads(body)["checks"]}
        check(status == 503 and not checks["not_overloaded"],
              f"P's /readyz while draining: {status} {checks}")

        # (8) the CLI: a node started on the card, queried, followed, stopped
        cli_home = home / "cli"
        code, _out = cli_out(["--home", str(cli_home), "init"])
        check(code == 0, "cli init failed")
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", str(cli_home),
             "--port", "0", "start", "--device", torch.device(dev).type, "--block-time",
             str(RPC_CLI_BLOCK_TIME)],
            cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        lines = LineReader(proc.stdout)
        cli_port = lines.until(r"rpc http://127\.0\.0\.1:(\d+)").group(1)
        cli_start_s = time.perf_counter() - t
        lines.until(r"^height 2 ")
        code, out = cli_out(["--port", cli_port, "query", "/header/2"])
        check(code == 0 and json.loads(out)["height"] == 2, f"cli query: {code} {out[:200]}")
        code, out = cli_out(["--home", str(cli_home), "--port", cli_port, "tx", "pfb",
                             "--size", str(RPC_CLI_PFB_BYTES)])
        check(code == 0 and json.loads(out)["code"] == 0, f"cli tx pfb: {code} {out[:300]}")
        m = lines.until(r"^height (\d+) txs 1 square (\d+) ")
        cli_height, cli_k = int(m.group(1)), int(m.group(2))
        check(cli_k >= GPU_MIN_SQUARE, f"the CLI node's PFB landed in a block of k = {cli_k}")
        cli_url = f"http://127.0.0.1:{cli_port}"
        code, out = cli_out(["light", "--primary", cli_url, "--from-height", str(cli_height),
                             "--once", "--sample", "4"])
        check(code == 0 and json.loads(out)["accepted"] is True
              and json.loads(out)["das"]["sampled"] == 4, f"cli light: {code} {out[:300]}")
        status, text = http_get(cli_url, "/metrics")
        ragged_d2h = [float(line.rsplit(" ", 1)[1]) for line in text.decode().splitlines()
                      if line.startswith("transfer_bytes_total{") and 'site="eds.ragged"' in line
                      and 'direction="d2h"' in line]
        check(status == 200 and sum(ragged_d2h) > 0,
              f"the CLI node's /metrics counts no ragged read of its pages: {ragged_d2h}")
        proc.send_signal(signal.SIGINT)
        lines.until(r"^node stopped")
        check(proc.wait(timeout=RPC_CLI_WAIT_S) == 0, f"the CLI node exited {proc.returncode}")
        proc = None
        check(json.loads((cli_home / "meta.json").read_text())["height"] >= 2,
              "the CLI node saved no snapshot at its head")
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
        for srv in servers:
            srv.stop()
        shutil.rmtree(home, ignore_errors=True)

    emit(phase="rpc", k=PROPOSAL_K, txs=len(raws),
         sample_http_ms=crowd_ms / len(crowd), sample_inprocess_ms=direct_ms / len(crowd),
         crowd_samples=len(crowd), crowd_threads=RPC_THREADS, crowd_batches=batches,
         crowd_memo_only_batches=needs.count(False),
         crowd_ragged_gather=crowd_counts["ragged_gather"],
         dah_ms=med(dah_ms), eds_ms=eds_ms, produce_block_http_ms=produce_http_ms,
         produce_block_ms=produce_ms, broadcast_tx_http_ms=med(broadcast_ms),
         crowd_inprocess_funnel_runs=funnel_runs, proof_tx_http_ms=proof_ms["proof"],
         namespace_data_absent_http_ms=proof_ms["namespace_data"],
         namespace_data_absent_rows=len(ns_doc["absence"]),
         light_client_samples=das["sampled"], fraud_detected=type(fraud_err).__name__,
         probe_cycles=len(cycles), probe_s=probe_s, grpc=grpc_doc,
         cli_start_s=cli_start_s, cli_pfb_height=cli_height, cli_pfb_k=cli_k,
         cli_ragged_d2h_bytes=sum(ragged_d2h), phase_seconds=time.perf_counter() - t_phase)


HARNESS_K = 128  # full width: a 32 MiB EDS a height
HARNESS_HEIGHTS = (1, 2, 3, 4)
HARNESS_SEED = 7  # the chaos chain's seed
HARNESS_BACKENDS = 3
HARNESS_SAMPLES = 256  # the crowd through the gateway
HARNESS_BUDGET_HEIGHTS = 2  # each paged node's device budget, in heights
HARNESS_SDC_HEIGHTS = 4  # audited blocks: clean, output flip, chunk flip, clean
HARNESS_SMOKE_SEED = 1337


def host_chain_dah(k: int, height: int, seed: int):
    """The chaos chain's DAH at ``height`` from the host ``da`` path alone:
    numpy's Leopard extension and hashlib's NMT roots and merkle root."""
    from celestia_tpu_torch import da
    from celestia_tpu_torch.ops import nmt_host
    from celestia_tpu_torch.testutil.chaosnet import chain_array

    eds = da.extend_host(chain_array(k, height, seed))
    w = 2 * k
    rows = [nmt_host.nmt_root(da.erasured_axis_leaves(
        [eds[i, j].tobytes() for j in range(w)], i, k)) for i in range(w)]
    cols = [nmt_host.nmt_root(da.erasured_axis_leaves(
        [eds[i, j].tobytes() for i in range(w)], j, k)) for j in range(w)]
    return da.DataAvailabilityHeader(rows, cols)


def harness_phase(dev, emit) -> None:
    """Phase 6k: the chaos harness, the gateway and the scenario engine on
    the card (see the module docstring). Every check raises; nothing is
    caught."""
    import concurrent.futures

    import torch

    from celestia_tpu_torch import faults, integrity, scenarios
    from celestia_tpu_torch.appconsts import SHARE_SIZE
    from celestia_tpu_torch.node.gateway import Gateway
    from celestia_tpu_torch.node.rpc import RpcServer
    from celestia_tpu_torch.ops import _cuda, transfers
    from celestia_tpu_torch.scenarios.world import ScenarioWorld, _verify_sample
    from celestia_tpu_torch.telemetry import Registry, metrics
    from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode, extend_chain

    t_phase = time.perf_counter()
    k, w = HARNESS_K, 2 * HARNESS_K
    budget = HARNESS_BUDGET_HEIGHTS * w * w * SHARE_SIZE
    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-harness-"))
    servers: dict = {}
    gw = None

    def serve(node) -> str:
        srv = RpcServer(node, port=0)
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        servers[url] = srv
        return url

    def counted(call):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, dict(_cuda.LAUNCHES)

    def verified(docs, payloads, dahs) -> bool:
        return all(_verify_sample(dahs[h], k, i, j, doc)
                   for (h, i, j), doc in zip(payloads, docs))

    try:
        # (a) three paged nodes on the card, each budget about two heights'
        # pages, behind their servers and one gateway; the first keeps a store
        # the nodes build their chains in threads: the native extend and
        # numpy's large operations run without the interpreter lock
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(HARNESS_BACKENDS + 2) as pool:
            ref_f = pool.submit(RpcChaosNode, heights=len(HARNESS_HEIGHTS), k=k,
                                seed=HARNESS_SEED, device="cpu")
            host_f = pool.submit(host_chain_dah, k, 1, HARNESS_SEED)
            node_fs = [pool.submit(RpcChaosNode, heights=len(HARNESS_HEIGHTS), k=k,
                                   seed=HARNESS_SEED, paged_budget_bytes=budget, device=dev,
                                   store_dir=home / "victim" if b == 0 else None)
                       for b in range(HARNESS_BACKENDS)]
            ref, host_dah = ref_f.result(), host_f.result()
            nodes = [f.result() for f in node_fs]
        build_s = time.perf_counter() - t0
        dahs = {h: ref.block_dah(h) for h in HARNESS_HEIGHTS}
        check(host_dah.hash() == dahs[1].hash(),
              "the chaos chain's DAH differs from the host da path's")
        urls = [serve(node) for node in nodes]
        check(transfers._device_executor() is None,
              "three servers in one process left a device executor registered")
        gw = Gateway(urls, timeout_s=120.0)
        gw.start()
        crowd = serving_crowd(HARNESS_SEED, HARNESS_HEIGHTS, w, HARNESS_SAMPLES)
        want = ref.sample_batch_ragged(crowd)
        check(verified(want, crowd, dahs), "the reference node's proofs do not verify")
        for node in nodes:
            check(all(node.block_dah(h).hash() == dahs[h].hash() for h in HARNESS_HEIGHTS),
                  "a paged node's DAH differs from the host chain's")
        batches0 = metrics.get_counter("dispatch_batch_total")
        hedges0 = metrics.get_counter("gateway_hedge_total")
        got, crowd_ms, launches = counted(lambda: http_crowd(gw.url, crowd, RPC_THREADS))
        batches = metrics.get_counter("dispatch_batch_total") - batches0
        emit(phase="main_path", entry="Gateway /sample", samples=len(crowd),
             threads=RPC_THREADS, backends=HARNESS_BACKENDS, batches=batches, launches=launches)
        check([s for s, _d in got] == [200] * len(crowd) and [d for _s, d in got] == want,
              "a sample through the gateway differs from the non-paged node's document")
        check(verified([d for _s, d in got], crowd, dahs),
              "a sample through the gateway failed NMT verification")
        check(0 < launches["ragged_gather"] <= batches
              and sum(launches.values()) == launches["ragged_gather"],
              f"the gateway crowd launched {launches} in {batches} dispatcher batches: "
              "ragged_gather, at most one a batch")
        # the ring's owner of each sample's (height, row) key
        split = collections.Counter(
            urls.index(gw.ring.owners(Gateway._route_key(f"/sample/{h}/{i}/{j}"), n=1)[0])
            for h, i, j in crowd)
        stats = [node._eds_cache.stats() for node in nodes]
        check(all(st["page_demotes"] > 0 and st["page_faultins"] > 0 for st in stats),
              f"a node's pages neither demoted nor faulted in under {budget} bytes: {stats}")
        _again, gateway_ms, _l = counted(lambda: http_crowd(gw.url, crowd, RPC_THREADS))
        direct, direct_ms, _l = counted(lambda: http_crowd(urls[1], crowd, RPC_THREADS))
        check([d for _s, d in direct] == want, "the direct crowd's documents differ")
        hedges = metrics.get_counter("gateway_hedge_total") - hedges0

        # (b) a restart from disk: the victim leaves the ring, a node with
        # heights=0 re-indexes its store and rejoins
        victim = urls[0]
        gw.remove_backend(victim)
        servers.pop(victim).stop()
        t1 = time.perf_counter()
        restarted = RpcChaosNode(heights=0, k=k, seed=HARNESS_SEED, paged_budget_bytes=budget,
                                 device=dev, store_dir=home / "victim")
        restart_s = time.perf_counter() - t1
        check(restarted.blocks == {} and restarted.store.heights() == list(HARNESS_HEIGHTS),
              "the restarted node did not re-index the victim's heights")
        reads0 = restarted.store.stats()["page_reads"]
        r_url = serve(restarted)
        probe = [(h, i, j) for h in HARNESS_HEIGHTS for i, j in ((0, 0), (k, w - 1), (w - 1, 3))]
        for h in HARNESS_HEIGHTS:
            status, body = http_get(r_url, f"/dah/{h}")
            check(status == 200 and json.loads(body) == dahs[h].to_json(),
                  f"the restarted node's /dah/{h} differs from the pre-restart DAH")
        r_docs = http_crowd(r_url, probe, RPC_THREADS)
        check(all(s == 200 for s, _d in r_docs)
              and verified([d for _s, d in r_docs], probe, dahs),
              "a pre-restart height failed NMT verification from the restarted node")
        reads = restarted.store.stats()["page_reads"] - reads0
        check(reads > 0, "the restarted node served without reading its store")
        gw.add_backend(r_url)
        rejoined = http_crowd(gw.url, crowd[:64], RPC_THREADS)
        check([d for _s, d in rejoined] == want[:64],
              "the ring with the restarted node answered other documents")
        emit(phase="harness", part="gateway", k=k, heights=len(HARNESS_HEIGHTS),
             backends=HARNESS_BACKENDS, samples=len(crowd), threads=RPC_THREADS,
             paged_budget_bytes=budget, ring_split=[split[b] for b in range(len(urls))],
             hedges=hedges, crowd_batches=batches,
             crowd_ragged_gather=launches["ragged_gather"],
             sample_gateway_ms=gateway_ms / len(crowd), sample_direct_ms=direct_ms / len(crowd),
             first_crowd_ms=crowd_ms, page_demotes=[st["page_demotes"] for st in stats],
             page_faultins=[st["page_faultins"] for st in stats], build_s=build_s,
             device_executor=False,
             device_executor_note="three servers in one process: no device executor "
                                  "(transfers._device_executor is None)",
             restart_reindex_s=restart_s, restart_page_reads=reads,
             rejoined_samples=len(rejoined))
    finally:
        if gw is not None:
            gw.stop()
        for srv in servers.values():
            srv.stop()
        shutil.rmtree(home, ignore_errors=True)

    # (c) the audited production at full width: the world's device path
    # under full audits, one flip at device.extend.output, one (sticky) at
    # transfer.chunk, with a clean block before each
    sc = scenarios.Scenario(name="harness-sdc", description="6k", k=k, sdc_producer=True,
                            phases=(scenarios.Phase(name="p", duration_s=1.0),))
    world = ScenarioWorld(sc, seed=HARNESS_SEED, registry=Registry(), device=dev)
    heights = list(range(2, 2 + HARNESS_SDC_HEIGHTS))
    clean = {}
    integrity.configure("full")
    try:
        with faults.inject(
                faults.rule("device.extend.output", "bitflip", times=1, after=1),
                faults.rule("transfer.chunk", "bitflip", times=2, after=4,
                            where="scenario.stage"), seed=HARNESS_SEED) as inj:
            for h in heights:
                _out, ms, counts = counted(lambda h=h: world._produce_block_device(h))
                if h == heights[0]:
                    clean = {"ms": ms, "launches": counts}
        timeline = list(inj.site_timeline)
    finally:
        integrity.configure("off")
    refs = {h: extend_chain(k, h, HARNESS_SEED)[1] for h in heights}
    check(all(world.node.block_dah(h).hash() == refs[h].hash() for h in heights),
          "a committed DAH differs from the host DAH")
    check(not world.sdc_missed and world.produced["device_blocks"] == 2,
          f"the audited production missed a flip or lost a clean block: {world.produced}, "
          f"missed {world.sdc_missed}")
    check([d["height"] for d in world.sdc_detections] == heights[1:3]
          and all(d["quarantined"] and d["host_dah"] == d["reference_dah"]
                  for d in world.sdc_detections) and world.node.app.sdc_quarantined,
          f"the flips were not each detected and quarantined: {world.sdc_detections}")
    check([site for _ph, site, _kind, _n in timeline] == ["device.extend.output",
                                                           "transfer.chunk", "transfer.chunk"],
          f"the flips struck {timeline}")
    lc = clean["launches"]
    check(lc["encode2d_hash"] == 3 and lc["leaf_digests2d"] == 1 and lc["nmt_tree"] == 1,
          f"a clean audited block launched {lc}: K1 3, K2 1, the tree 1")
    emit(phase="main_path", entry="ScenarioWorld._produce_block_device", k=k,
         audit="full", launches=lc)

    # (d) the smoke suite twice on one seed on the card
    runs = []
    for _ in range(2):
        t2 = time.perf_counter()
        report = scenarios.run_scenario(scenarios.get("smoke"), seed=HARNESS_SMOKE_SEED,
                                        device=dev)
        runs.append((report, time.perf_counter() - t2))
    (r1, s1), (r2, s2) = runs
    check(r1["scenario_slo_pass"] and r2["scenario_slo_pass"],
          f"the smoke scenario failed its verdict: {r1['verdict']} {r2['verdict']}")
    check(r1["fault_timeline"] == r2["fault_timeline"] and r1["fault_timeline"],
          "the smoke scenario's fault timelines differ between two runs of one seed")
    check(r1["world"]["produced"]["device_blocks"] > 0
          and r2["world"]["produced"]["device_blocks"] > 0,
          "the smoke scenario produced no block on the card")
    emit(phase="harness", part="audited_production", k=k, blocks=len(heights),
         clean_block_ms=clean["ms"], clean_block_launches=lc,
         detections=[(d["height"], d["site"]) for d in world.sdc_detections],
         produced=world.produced)
    emit(phase="harness", part="smoke", seed=HARNESS_SMOKE_SEED,
         wall_s=[s1, s2], heights=[r1["world"]["heights"], r2["world"]["heights"]],
         produced=[r1["world"]["produced"], r2["world"]["produced"]],
         faults=len(r1["fault_timeline"]), das_ok=[r1["world"]["das"]["ok"],
                                                   r2["world"]["das"]["ok"]],
         breaching=r1["verdict"]["breaching_objectives"])
    emit(phase="harness", part="phase_seconds", phase_seconds=time.perf_counter() - t_phase)


def mesh_launches(sp: int, call: str) -> dict[str, int]:
    """The launches of one dense call on a mesh of sp shards: each shard K2
    on its Q0 rows and K1 three times (its Q1 rows, the whole Q2 from the
    gathered Q0, its Q3 rows); then ``roots`` the tree once over the
    gathered grid, ``extend`` that and the DAH merkle, and ``row_c`` each
    shard's row-block tree, one over the gathered grid's transpose (the
    column roots) and the DAH merkle."""
    shards = {"leaf_digests2d": sp, "encode2d_hash": 3 * sp}
    return {**shards, **{"roots": {"nmt_tree": 1},
                         "extend": {"nmt_tree": 1, "dah_merkle": 1},
                         "row_c": {"nmt_tree_rows": sp + 1, "dah_merkle": 1}}[call]}


def row_blocks(k: int) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Row blocks of the (2k, 2k) grid for the row-block mode: (top rows
    [a, b), bottom rows [c, d)). A range that starts in the top half and
    ends in the bottom, ranges inside one half, one row, and each shard's
    block of a (1, 2) and a (1, 4) mesh (its top rows, then its bottom rows
    k rows on)."""
    out = {((0, k), (k, 2 * k)), ((0, 1), (k, k)), ((k - 1, k), (k, 2 * k)),
           ((0, 0), (2 * k - 1, 2 * k)), ((k // 2, k), (k, k + k // 2 + 1))}
    for sp in (2, 4):
        if k % sp == 0:
            rp = k // sp
            out |= {((i * rp, (i + 1) * rp), (k + i * rp, k + (i + 1) * rp)) for i in range(sp)}
    return sorted(out)


def multihost_worker(rank: int, world: int, port: int, path: str) -> int:
    """One rank of phase 6i's second multi-host case: a gloo group (named:
    NCCL refuses two ranks on one card), this rank's squares of the batch
    in ``path`` extended on a (1, 2) mesh of virtual shards on cuda:0, and
    every rank's DAHs gathered; prints them as one JSON line."""
    import torch.distributed as dist

    from celestia_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         local_devices=["cuda:0", "cuda:0"])
    try:
        mesh = multihost.process_mesh(sp=2)
        batch = np.load(path)
        per = len(batch) // world
        local = batch[rank * per:(rank + 1) * per]
        fn = multihost.distributed_extend_and_root(mesh, batch.shape[1])
        _eds, _rows, _cols, dah = fn(multihost.shard_batch_from_host(local, mesh))
        dahs = multihost.gather_to_hosts(dah, mesh)
        print(json.dumps({"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
                          "device": str(dah.device), "dahs": [d.tobytes().hex() for d in dahs]}),
              flush=True)
    finally:
        multihost.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(dev, emit, same, squares: list, stream: list, tree_square, dev_bytes) -> int:
    """Phase 6i: multi-GPU on the card (see the module docstring).
    ``squares``: bench.py's square at k = 128, seeds 42-45; ``stream``: the
    six squares of phase 6h; ``tree_square(k, kind)`` and ``dev_bytes``:
    phase 2's namespace squares and random bytes on the card. Returns the
    pipeline's launches of nmt_tree_rows (the main path the kernels line
    reads). Every check raises; nothing is caught (the subprocesses are
    killed on the way out)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from celestia_tpu_torch import da, parallel, tracing
    from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_tpu_torch.node.pipeline import BlockPipeline
    from celestia_tpu_torch.ops import _cuda, extend, nmt_cuda
    from celestia_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    k = squares[0].shape[0]
    zero = dict.fromkeys(_cuda.LAUNCHES, 0)
    n_cards = torch.cuda.device_count()
    card0 = torch.device("cuda", 0)

    def counted(call):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = call()
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES)

    def wall_ms(call) -> float:
        """Host ms of one call ended by a synchronize of the card."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    # (a) the tree's row-block mode against its plain version on the card:
    # random digest grids under phase 2's namespace squares; the plain
    # version once over all 2k rows with their levels and once over the
    # grid's transpose (the column roots), the kernel on every row block of
    # row_blocks(k) against the plain rows it covers, and on the transpose
    cases = 0
    for kk, kinds in MESH_TREE_CASES:
        for kind in kinds:
            grid = dev_bytes((2 * kk, 2 * kk, 32)).view(torch.int32).view(torch.uint32)
            q0_ns = tree_square(kk, kind)[..., :NAMESPACE_SIZE]
            quads = (grid[:kk, :kk], grid[:kk, kk:], grid[kk:, :kk], grid[kk:, kk:])
            t_quads = tuple(q.transpose(0, 1) for q in (quads[0], quads[2], quads[1], quads[3]))
            plain_rows, plain_levels = nmt_cuda.nmt_tree_rows_reference(quads, q0_ns, True)
            plain_views = nmt_cuda.split_levels(plain_levels, kk)
            plain_cols, _none = nmt_cuda.nmt_tree_rows_reference(t_quads, q0_ns.transpose(0, 1))
            for (a, b), (c, d) in row_blocks(kk):
                tiles = (grid[a:b, :kk], grid[a:b, kk:], grid[c:d, :kk], grid[c:d, kk:])
                roots, levels = nmt_cuda.nmt_tree_rows(tiles, q0_ns[a:b] if b > a else None, True)
                what = f"nmt_tree_rows k={kk} {kind} rows [{a}, {b}) + [{c}, {d})"
                same("nmt_tree_rows", roots[0], torch.cat([plain_rows[0, a:b], plain_rows[0, c:d]]),
                     f"{what}: roots")
                for lv, (got, want) in enumerate(zip(
                        nmt_cuda.split_levels(levels, kk, (b - a) + (d - c)), plain_views)):
                    same("nmt_tree_rows", got, torch.cat([want[a:b], want[c:d]]),
                         f"{what}: level {lv}")
                cases += 1
            cols, none = nmt_cuda.nmt_tree_rows(t_quads, q0_ns.transpose(0, 1))
            check(none is None, "the row-block mode returned levels it was not asked for")
            same("nmt_tree_rows", cols, plain_cols, f"nmt_tree_rows k={kk} {kind}: column roots")
            whole, _none = nmt_cuda.nmt_tree(quads, q0_ns)
            same("nmt_tree_rows", torch.stack([plain_rows[0], plain_cols[0]]), whole,
                 f"k={kk} {kind}: the plain row-block mode against the tree kernel")
            cases += 1
    torch.cuda.synchronize()
    emit(phase="kernel_vs_plain", kernel="nmt_tree_rows", cases=cases, tolerance=0,
         ks={kk: list(kinds) for kk, kinds in MESH_TREE_CASES},
         outputs=["row roots and levels of each row block", "column roots (the transpose)"],
         seconds=time.perf_counter() - t_phase)

    # (b) the single-device references, no mesh configured
    parallel.configure_mesh(None)
    sq = squares[0]
    ref = extend.extend_and_root_device(sq, dev)
    ref_levels = extend.eds_row_levels_device(ref[0], dev)
    ref_entries = {
        "roots_device": extend.roots_device(sq, dev),
        "extend_roots_device": extend.extend_roots_device(sq, dev),
        "extend_and_root_device": ref,
        "eds_row_levels_device": ref_levels,
    }
    ref_stream = []
    for s in stream:
        eds, rows, cols, dah = extend.extend_and_root_device(s, dev)
        ref_stream.append((eds, rows, cols, dah, extend.eds_row_levels_device(eds, dev)))
    x = torch.from_numpy(sq).to(dev)

    def event_ms(call) -> float:
        """CUDA-event ms of one call on the current stream, its launches'
        host gaps included."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def timed_turns(mesh) -> dict:
        """MESH_REPS turns of sp = 1 (no mesh) then the mesh, each after one
        untimed call (the mesh's builders rebuild after a flip): median ms
        of roots_device and Row C by the host clock, and of Row C by CUDA
        events."""
        calls = {"roots_device": lambda: extend.roots_device(sq, dev),
                 "row_c": lambda: extend.extend_root_levels_staged(x)}
        out = {side: {"roots_device": [], "row_c": [], "row_c_event": []}
               for side in ("sp1", "mesh")}
        for _ in range(MESH_REPS):
            for side in ("sp1", "mesh"):
                parallel.configure_mesh(None if side == "sp1" else mesh)
                for call in calls.values():
                    call()
                for name, call in calls.items():
                    out[side][name].append(wall_ms(call))
                out[side]["row_c_event"].append(event_ms(calls["row_c"]))
        parallel.configure_mesh(mesh)
        return {side: {name: statistics.median(v) for name, v in d.items()}
                for side, d in out.items()}

    def entries():
        resident, rows, cols = extend.extend_roots_device_resident(sq, dev)
        return {
            "roots_device": extend.roots_device(sq, dev),
            "extend_roots_device": extend.extend_roots_device(sq, dev),
            "extend_roots_device_resident": (resident.cpu().numpy(), rows, cols),
            "extend_and_root_device": extend.extend_and_root_device(sq, dev),
            "eds_row_levels_device": extend.eds_row_levels_device(ref[0], dev),
        }

    ref_entries["extend_roots_device_resident"] = ref_entries["extend_roots_device"]

    # (c) every mesh: the routed entries, Row C and the XOR spelling against
    # the single-device route; a call's ms, launches and collective bytes
    t_part = time.perf_counter()
    layouts = [("virtual", [card0] * 4)]
    if n_cards > 1:
        layouts.append(("cards", [torch.device("cuda", i % n_cards) for i in range(4)]))
    for layout, devices in layouts:
        for dp, sp in MESH_SHAPES:
            mesh = parallel.make_mesh(dp, sp, devices[:dp * sp])
            parallel.configure_mesh(mesh)
            check(extend._mesh_if_divisible(k) is mesh, f"{mesh} does not route k = {k}")
            got = entries()
            for name, want in ref_entries.items():
                check(len(got[name]) == len(want)
                      and all(np.array_equal(a, b) for a, b in zip(got[name], want)),
                      f"{layout} mesh {(dp, sp)}: {name} differs from the single-device route")
            row_c, row_c_counts = counted(lambda: extend.extend_root_levels_staged(x))
            check(row_c_counts == {**zero, **mesh_launches(sp, "row_c")},
                  f"mesh {(dp, sp)}: Row C launched {row_c_counts}")
            check(all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(row_c[:4], ref))
                  and len(row_c[4]) == len(ref_levels)
                  and all(np.array_equal(a.cpu().numpy(), b)
                          for a, b in zip(row_c[4], ref_levels)),
                  f"mesh {(dp, sp)}: Row C differs from the unfused single-device pair")
            xor_out = parallel.extend_and_root_rowsharded(mesh, k, xor=True)(sq)
            check(all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(xor_out, ref)),
                  f"mesh {(dp, sp)}: the XOR spelling differs from the dense one")
            _out, roots_counts = counted(lambda: extend.roots_device(sq, dev))
            check(roots_counts == {**zero, **mesh_launches(sp, "roots")},
                  f"mesh {(dp, sp)}: roots_device launched {roots_counts}")
            parallel.reset_collective_bytes()
            extend.roots_device(sq, dev)
            roots_bytes = dict(parallel.COLLECTIVE_BYTES)
            parallel.reset_collective_bytes()
            extend.extend_root_levels_staged(x)
            row_c_bytes = dict(parallel.COLLECTIVE_BYTES)
            ms = timed_turns(mesh)
            emit(phase="mesh", part="entries", layout=layout, mesh=[dp, sp],
                 devices=[str(d) for d in mesh.devices.reshape(-1)], device_count=n_cards, k=k,
                 identical=sorted(ref_entries) + ["row_c", "xor"],
                 roots_device_ms=ms["mesh"]["roots_device"],
                 roots_device_sp1_ms=ms["sp1"]["roots_device"],
                 row_c_ms=ms["mesh"]["row_c"], row_c_sp1_ms=ms["sp1"]["row_c"],
                 row_c_event_ms=ms["mesh"]["row_c_event"],
                 row_c_event_sp1_ms=ms["sp1"]["row_c_event"],
                 launches={"roots_device": {n: c for n, c in roots_counts.items() if c},
                           "row_c": {n: c for n, c in row_c_counts.items() if c}},
                 collective_bytes={"roots_device": roots_bytes, "row_c": row_c_bytes},
                 seconds=time.perf_counter() - t_part,
                 note="shards of one card run in turn: the cost of sharding, not a speed-up"
                 if layout == "virtual" else "shards on distinct cards")
            t_part = time.perf_counter()
    if n_cards == 1:
        emit(phase="mesh", part="distinct_cards", device_count=n_cards,
             ran=False, note="one card: the meshes over distinct cards need two or more")

    # (d) a k that sp = 3 does not divide falls back to the single-device route
    parallel.configure_mesh(parallel.make_mesh(1, 3, [card0] * 3))
    check(extend._mesh_if_divisible(k) is None, f"sp = 3 routes k = {k}")
    tracing.enable()
    try:
        with tracing.record() as rec:
            fallback, counts = counted(lambda: extend.roots_device(sq, dev))
    finally:
        tracing.disable()
    sharded = [s.attrs["sharded"] for s in rec.spans if s.name == "extend.rs_nmt"]
    check(all(np.array_equal(a, b) for a, b in zip(fallback, ref_entries["roots_device"]))
          and sharded == [False]
          and counts == {**zero, "leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1},
          f"sp = 3 at k = {k}: {counts}, sharded {sharded}")
    emit(phase="mesh", part="fallback", mesh=[1, 3], k=k, sharded=sharded[0], launches={
        n: c for n, c in counts.items() if c})

    # (e) the main path: phase 6h's six squares through a 3-deep pipeline
    # on the (1, 2) mesh, the launches counted
    dp, sp = MESH_MAIN
    parallel.configure_mesh(parallel.make_mesh(dp, sp, [card0] * (dp * sp)))
    pipe = BlockPipeline(k, depth=3, device=dev)
    (blocks, stream_s), p_counts = counted(lambda: stream_blocks(pipe, stream))
    want = {**zero, **{n: c * len(stream) for n, c in mesh_launches(sp, "row_c").items()}}
    emit(phase="main_path", entry="BlockPipeline.feed", mesh=[dp, sp], k=k, blocks=len(stream),
         depth=3, launches=p_counts, stream_s=stream_s)
    check(p_counts == want, f"the mesh pipeline launched {p_counts}: {want} expected")
    check([b.height for b in blocks] == list(range(len(stream)))
          and all(same_block(b, ref_stream[b.height]) for b in blocks),
          "a block of the mesh pipeline differs from the single-device entries")
    parallel.configure_mesh(None)
    del blocks

    # (f) multi-host, first case: a one-rank NCCL group runs the batch on a
    # (1, 2) mesh of virtual shards and gathers its DAH
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, local_devices=[card0, card0])
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"a group of CUDA devices formed over {backend}")
        mesh = multihost.process_mesh(sp=2)
        out = multihost.distributed_extend_and_root(mesh, k)(
            multihost.shard_batch_from_host(np.stack(squares[:1]), mesh))
        nccl_dahs = multihost.gather_to_hosts(out[3], mesh)
    finally:
        multihost.shutdown()
    check(nccl_dahs.shape == (1, 32) and nccl_dahs[0].tobytes() == ref[3].tobytes(),
          "the NCCL group's gathered DAH differs from the single-device DAH")

    # (g) multi-host, second case: two processes on the one card over gloo,
    # each extending its dp square; every rank's gathered DAHs against the
    # host path's
    batch = np.stack(squares[:2])
    host_dahs = [da.new_data_availability_header(da.extend_shares(
        s.reshape(-1, SHARE_SIZE))).hash().hex() for s in batch]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    procs = []
    try:
        path = os.path.join(tmp, "batch.npy")
        np.save(path, batch)
        port = free_port()
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--multihost-worker", str(r), "2", str(port), path],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = [p.communicate(timeout=240) for p in procs]
        gloo_s = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    docs = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multi-host rank {r} exited {p.returncode}: {err[-2000:]}")
        docs.append(json.loads(out.strip().splitlines()[-1]))
    check(all(d["backend"] == "gloo" and d["device"] == "cuda:0" and d["dahs"] == host_dahs
              for d in docs), f"the gloo ranks' DAHs differ from the host path's: {docs}")
    emit(phase="mesh", part="multihost", k=k,
         nccl={"ranks": 1, "mesh": [1, 2], "dah": nccl_dahs[0].tobytes().hex()},
         gloo={"ranks": 2, "mesh_per_rank": [1, 2], "global_dp": 2, "seconds": gloo_s,
               "dahs": host_dahs}, phase_seconds=time.perf_counter() - t_phase)
    return p_counts["nmt_tree_rows"]


def mesh_only(dev, emit, same, bench_square, tree_square, dev_bytes, smi_line: str) -> int:
    """``--mesh-only``: phase 6i alone, after the build, on phase 6i's
    squares. On several cards its meshes over distinct cards run beside the
    virtual ones. Prints the card's line last and no ``ok`` line: this is
    not the smoke run."""
    t = time.perf_counter()
    rows_launches = mesh_phase(dev, emit, same, [bench_square(SERVING_K, s) for s in MESH_SEEDS],
                               [bench_square(SERVING_K, s) for s in LANE_SEEDS], tree_square,
                               dev_bytes)
    emit(phase="mesh_only", seconds=time.perf_counter() - t,
         pipeline_launches={"nmt_tree_rows": rows_launches})
    print(smi_line, flush=True)
    return 0


def assembly_case(k: int, seed: int, family: str) -> dict[str, np.ndarray]:
    """Inputs of ``extend.assembled_roots`` (its host arrays, and the arena's
    bytes) for one of ASSEMBLY_FAMILIES at k: blobs at strictly ascending
    starts with a random share count each (mostly a full blob's bytes,
    sometimes fewer), the host cells every cell no blob covers, except:
    ``one_blob``, one blob; ``no_blobs``, none, half the cells host cells;
    ``host_over_blob``, a quarter of all cells host cells, blob cells among
    them; ``uncovered``, no host cell, cell 0 before every blob and each
    blob over half its gap (the rest blob 0's namespace and zeros); ``arena_edge``, blobs that run past the
    arena's end (their indexes clamped); ``misaligned``, the arena's
    alignments (``misaligned_blobs``)."""
    if family not in ASSEMBLY_FAMILIES:
        raise ValueError(f"unknown assembly family {family!r}")
    r = np.random.default_rng(seed)
    s = k * k
    n_arena = max(8192, s * 256)
    if family == "misaligned":
        n_arena += 7  # not a multiple of 16: the arena's last vector is partial
        starts, nsh, lens, offs = misaligned_blobs(r, s, n_arena)
    else:
        if family == "no_blobs":
            starts: list[int] = []
        elif family == "one_blob":
            starts = [int(r.integers(0, max(1, s // 4)))]
        elif family == "uncovered" and s > 1:  # cell 0 and each blob's tail uncovered
            starts = sorted(int(x) + 1 for x in r.choice(
                s - 1, size=min(max(1, s // 4), int(r.integers(2, 65))), replace=False))
        else:
            starts = sorted(int(x) for x in r.choice(s, size=min(s, int(r.integers(2, 65))),
                                                     replace=False))
        nsh, lens, offs = [], [], []
        for st, en in zip(starts, starts[1:] + [s]):
            gap = en - st
            n = max(1, gap // 2) if family == "uncovered" else int(r.integers(1, gap + 1))
            full = FIRST_SPARSE + (n - 1) * CONT_SPARSE
            lo = full - CONT_SPARSE + 1 if n > 1 and r.random() < 0.8 else 1
            ln = int(r.integers(lo, full + 1))
            off = (n_arena - ln // 2 if family == "arena_edge"
                   else int(r.integers(0, max(1, n_arena - ln))))
            nsh.append(n)
            lens.append(ln)
            offs.append(off)
    covered = np.zeros(s, bool)
    for st, n in zip(starts, nsh):
        covered[st: st + n] = True
    if family == "host_over_blob":
        pos = np.flatnonzero(r.random(s) < 0.25)
    elif family == "uncovered":
        pos = np.zeros(0, np.int64)
    elif family == "no_blobs":
        pos = np.flatnonzero(r.random(s) < 0.5)
    else:
        pos = np.flatnonzero(~covered)
    h = min(len(pos), 7)
    return {
        "arena": r.integers(0, 256, n_arena, dtype=np.uint8),
        "host_shares": r.integers(0, 256, (h, 512), dtype=np.uint8),
        "host_pos": pos.astype(np.int32),
        "host_row": r.integers(0, max(h, 1), len(pos)).astype(np.int32),
        "blob_start": np.asarray(starts, np.int32),
        "blob_nshares": np.asarray(nsh, np.int32),
        "blob_off": np.asarray(offs, np.int32),
        "blob_len": np.asarray(lens, np.int32),
        "ns_table": r.integers(0, 256, (len(starts), 29), dtype=np.uint8),
    }


def misaligned_blobs(r: np.random.Generator, s: int, n_arena: int):
    """(starts, shares, lengths, offsets) of the ``misaligned`` family over
    s cells: one one-share blob that ends on the arena's last byte, then 16
    blobs whose offsets take every residue mod 16 (so a first share's shift
    takes all 16 values) and whose last shares end at every residue mod 16
    of the cell, one of them a full share; the first even- and odd-offset
    blobs have 9 shares (their later shares' shifts, off + 2 (j - 1) mod 16,
    take the other 8 values each), the rest 1 to 3, at least two of them
    one share. A blob whose shares do not fit after those before it is left
    out; every blob fits from s = 64 (k = 8) on. They lie in the square in
    a random order, with random gaps."""
    res, tails = r.permutation(16), r.permutation(16)
    long_ = {int(np.flatnonzero(res % 2 == 0)[0]), int(np.flatnonzero(res % 2 == 1)[0])}
    short = [i for i in range(16) if i not in long_]
    one = set(short[:2])
    blobs = []  # (shares, length, offset)
    end_len = int(r.integers(1, FIRST_SPARSE + 1))
    blobs.append((1, end_len, n_arena - end_len))
    for i in range(16):
        n = 9 if i in long_ else 1 if i in one else int(r.integers(1, 4))
        cap, prefix = (FIRST_SPARSE, FIRST_PREFIX) if n == 1 else (CONT_SPARSE, CONT_PREFIX)
        if tails[i] == 0:
            last = cap  # ends at the cell's last byte
        else:
            last = int((tails[i] - prefix) % 16) + 16 * int(r.integers(0, cap // 16 - 2))
            last = last or 16
        ln = (0 if n == 1 else FIRST_SPARSE + (n - 2) * CONT_SPARSE) + last
        off = 16 * int(r.integers(0, (n_arena - ln - res[i]) // 16 + 1)) + int(res[i])
        blobs.append((n, ln, off))
    kept, used = [], 0
    for b in blobs:
        if used + b[0] <= s:
            kept.append(b)
            used += b[0]
    kept = [kept[i] for i in r.permutation(len(kept))]
    gaps = r.multinomial(s - used, np.ones(len(kept) + 1) / (len(kept) + 1))
    starts, at = [], 0
    for (n, _ln, _off), g in zip(kept, gaps):
        at += int(g)
        starts.append(at)
        at += n
    return (starts, [b[0] for b in kept], [b[1] for b in kept], [b[2] for b in kept])


def assembly_bytes(k: int, blob_len, host_rows: int) -> int:
    """The bytes the assembly must move: every cell written once, every
    blob byte and every host row read once."""
    return k * k * 512 + int(np.sum(np.asarray(blob_len, np.int64))) + host_rows * 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> tuple[str, str, str]:
    line = smi("name,power.limit")
    name, limit = (s.strip() for s in line.split(",", 1))
    return line, name, limit


def fft_butterflies(multiplies: np.ndarray) -> tuple[int, int]:
    """(multiply, plain) butterflies per lane of an FFT program over k
    positions, one bool a butterfly group, True where its twiddle is
    nonzero (ops/rs.py fft_program and decode_program order: IFFT levels
    with dist 1 -> k/2, then FFT levels with dist k/2 -> 1; a zero twiddle's
    butterflies skip the multiply)."""
    k = len(multiplies) // 2 + 1
    levels = [1 << lv for lv in range(k.bit_length() - 1)]
    dists = [d for d in levels for _ in range(k // (2 * d))]
    dists += [d for d in reversed(levels) for _ in range(k // (2 * d))]
    mul = sum(d for d, m in zip(dists, multiplies.tolist()) if m)
    return mul, sum(dists) - mul


def repair_masks(k: int) -> list[tuple[str, np.ndarray]]:
    """The repair phase's presence masks of a 2k x 2k EDS: bench.py's four
    (seeds 7-10, 25% of the cells erased at random), each one row sweep,
    and tests/test_repair.py's multi-sweep mask (a full row, a full column
    and a corner), a row sweep and then a column sweep."""
    w = 2 * k
    out = []
    for seed in (7, 8, 9, 10):
        r = np.random.default_rng(seed)
        present = np.ones((w, w), dtype=bool)
        present.reshape(-1)[r.choice(w * w, size=int(0.25 * w * w), replace=False)] = False
        out.append((f"random_{seed}", present))
    present = np.ones((w, w), dtype=bool)
    present[1, :] = False
    present[:, 2] = False
    present[0, 0] = False
    out.append(("row_column_corner", present))
    return out


def numpy_locator(erased: np.ndarray) -> np.ndarray:
    """The JAX package's spelling of gf256._error_locator_logs_batch: the
    same product through numpy's float64 dgemm (the port runs it through
    torch); the repair phase times the repair entries under each."""
    from celestia_tpu_torch.ops import gf256

    err = np.zeros((erased.shape[0], gf256.K_ORDER), dtype=np.float64)
    err[:, : erased.shape[1]] = erased
    return (err @ gf256._locator_matrix()).astype(np.int64) % gf256.K_MODULUS


def decode_sweep_work(twiddles: np.ndarray, scale_bytes: np.ndarray,
                      write: np.ndarray) -> dict[str, float]:
    """The work of one decode sweep on its plan's data, counted as
    ``fft_butterflies`` counts the encode: the core's butterflies from the
    decode program's twiddles (``rs.decode_program(n)``: IFFT levels, then
    FFT levels, 0 a zero twiddle) for every axis the sweep writes, each byte a
    lane; a multiply by a per-position constant for every cell read (a
    nonzero scale) and every cell written. ALU operations per 4-lane word:
    FFT_MUL_OPS per multiply butterfly, FFT_PLAIN_OPS per plain one,
    CONST_MUL_OPS per constant multiply; one byte lookup per multiply and
    lane. Bytes: each read and written cell once, and the plan's three
    (w, n) arrays. An axis the sweep writes nothing of needs no work."""
    mul, plain = fft_butterflies(twiddles != 0)
    active = write.any(axis=1)
    axes = int(active.sum())
    reads = int((scale_bytes[active] != 0).sum())
    written = int(write.sum())
    words = CELL_BYTES / 4
    return {
        "axes": axes, "mul_butterflies": mul, "plain_butterflies": plain,
        "reads": reads, "written": written,
        "alu_ops": (axes * (mul * FFT_MUL_OPS + plain * FFT_PLAIN_OPS)
                    + (reads + written) * CONST_MUL_OPS) * words,
        "lookups": (axes * mul + reads + written) * CELL_BYTES,
        "bytes": (reads + written) * CELL_BYTES + 3 * scale_bytes.size,
    }


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory per kernel, from
    nvcc's ``-Xptxas -v`` log, keyed by the mangled kernel name."""
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if name and m:
                out[name][key] = int(m.group(1))
    return out


def sass_functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """(address, opcode with its modifiers, operands) of every instruction of
    every kernel in ``cuobjdump -sass`` output, by mangled kernel name."""
    insn = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;\n]*);")
    out = {}
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)", sass, re.S):
        out[m.group(1)] = [(int(i.group(1), 16), i.group(2), i.group(3).strip())
                           for i in insn.finditer(m.group(2))]
    return out


def sass_mix(sass: str, fragment: str) -> dict[str, collections.Counter]:
    """Opcode counts (without modifiers) of each kernel whose mangled name
    contains ``fragment``."""
    return {name: collections.Counter(op.split(".")[0] for _a, op, _r in lines)
            for name, lines in sass_functions(sass).items() if fragment in name}


def sass_lines(sass: str, fragment: str) -> list[tuple[int, str, str]]:
    """The instructions of the one kernel whose mangled name contains
    ``fragment``."""
    funcs = [lines for name, lines in sass_functions(sass).items() if fragment in name]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} kernels match {fragment!r}")
    return funcs[0]


def sass_loops(lines: list[tuple[int, str, str]]) -> list[collections.Counter]:
    """Opcode counts (with modifiers) of one pass of each loop of a kernel:
    the instructions from the target of a backward branch to that branch,
    widest loop first."""
    loops = []
    for addr, op, args in lines:
        target = re.findall(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else []
        if target and int(target[-1], 16) < addr:
            loops.append((int(target[-1], 16), addr))
    loops.sort(key=lambda t: t[0] - t[1])
    return [collections.Counter(op for addr, op, _ in lines if lo <= addr <= hi)
            for lo, hi in loops]


def block_loop_mix(sass: str, fragment: str) -> collections.Counter:
    """One pass of the kernel's widest loop (K3's: one SHA-256 block)."""
    loops = sass_loops(sass_lines(sass, fragment))
    if not loops:
        raise ValueError(f"no loop in the SASS of {fragment!r}")
    return loops[0]


def opcode_counts(loop: collections.Counter, names) -> dict[str, int]:
    """Instructions of each base opcode in ``names`` (modifiers dropped)."""
    return {name: sum(n for op, n in loop.items() if op.split(".")[0] == name)
            for name in names}


def rounds_loop_mix(sass: str, fragment: str) -> collections.Counter:
    """One pass of the tree kernel's rounds-only loop (compress_kw in
    csrc/nmt_tree.cu: the 64 rounds of a block over a K + W its helper
    threads expanded): the shortest loop whose pass holds exactly 64
    shared-memory loads, one K + W word a round."""
    rounds = [mix for mix in sass_loops(sass_lines(sass, fragment))
              if sum(n for op, n in mix.items() if op.split(".")[0] == "LDS") == 64]
    if not rounds:
        raise ValueError(f"no loop of 64 shared loads in the SASS of {fragment!r}")
    return min(rounds, key=lambda mix: sum(mix.values()))


def sha_block_ops(loop: collections.Counter) -> tuple[int, int]:
    """(ALU-pipe, FMA-pipe) operations of one SHA-256 block in K3's loop:
    LOP3, SHF, IADD3 and PRMT, and IMAD other than the 64-bit IMAD.WIDE
    of the loads' addresses."""
    base = collections.Counter()
    for op, n in loop.items():
        base[op.split(".")[0] if not op.startswith("IMAD.WIDE") else "IMAD.WIDE"] += n
    return sum(base[op] for op in SHA_ALU_OPS), base["IMAD"]


def pipe_seconds(alu: float, fma: float) -> float:
    """The least time for ``alu`` ALU-pipe and ``fma`` FMA-pipe lane
    operations on the card: each pipe at its lane rate, and both within the
    issue rate."""
    return max(alu / ALU_LANES, fma / FMA_LANES, (alu + fma) / ISSUE_LANES) / (SMS * CLOCK_HZ)


def chain_block_seconds(alu: float, fma: float) -> float:
    """One warp's SHA-256 block alone on an SM sub-partition (16 ALU lanes,
    32 FMA lanes, one warp instruction issued a clock): the latency floor
    of a chain of compressions."""
    warp = 32
    return max(alu * warp / (ALU_LANES / 4), fma * warp / (FMA_LANES / 4),
               (alu + fma) * warp / (ISSUE_LANES / 4)) / CLOCK_HZ


def chain_floor_seconds(level_messages, blocks: int, alu: float, fma: float) -> float:
    """The least time of a tree hashed one whole level after another, level
    i hashing level_messages[i] messages of ``blocks`` SHA-256 blocks: each
    level at least its throughput time and at least one chain of its
    blocks. This is the floor of that design (one launch a level, or every
    tree's level at once), not of the function: independent subtrees need
    not wait for each other's levels."""
    return sum(max(pipe_seconds(m * blocks * alu, m * blocks * fma),
                   blocks * chain_block_seconds(alu, fma)) for m in level_messages)


def tree_chain_seconds(depth: int, blocks: int, round_alu: float, round_fma: float) -> float:
    """One tree's critical path: ``depth`` dependent messages of ``blocks``
    SHA-256 blocks, each block at least its 64 rounds (``round_alu`` and
    ``round_fma`` operations) at one warp's issue rate. The message
    schedule is off that path: other threads can expand it beforehand."""
    return depth * blocks * chain_block_seconds(round_alu, round_fma)


def dah_levels(k: int) -> list[int]:
    """Messages of each level of a DAH's merkle tree over its 4k axis
    roots: the 4k leaves, then 2k, k, ..., 1 nodes (2 SHA-256 blocks each)."""
    return [4 * k >> lv for lv in range((4 * k).bit_length())]


def nmt_tree_levels(k: int, families: int) -> list[int]:
    """Inner nodes of each level of ``families`` families of 2k NMT trees of
    2k leaves, leaves' parents first."""
    w = 2 * k
    return [families * w * (w >> lv) for lv in range(1, w.bit_length())]


def nmt_tree_floor(k: int, families: int, alu: float, fma: float, round_alu: float,
                   round_fma: float) -> tuple[float, float]:
    """(throughput, chain) in seconds, the two terms of the least time of
    the NMT inner nodes of ``families`` families of 2k trees of 2k leaves
    (3 SHA-256 blocks a node): all nodes at the card's rate (a block is
    ``alu`` + ``fma`` operations), and one tree's log2(2k) levels of 3
    blocks' rounds in a row. The bound is the larger."""
    levels = nmt_tree_levels(k, families)
    throughput = pipe_seconds(sum(levels) * NODE_BLOCKS * alu, sum(levels) * NODE_BLOCKS * fma)
    return throughput, tree_chain_seconds(len(levels), NODE_BLOCKS, round_alu, round_fma)


def hashlib_merkle(items: np.ndarray) -> bytes:
    """RFC-6962 merkle root of (n, D) items through hashlib, n a power of
    two (leaf SHA-256(0x00 ‖ item), node SHA-256(0x01 ‖ left ‖ right))."""
    nodes = [hashlib.sha256(b"\x00" + it.tobytes()).digest() for it in items]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(b"\x01" + nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def shuffled_layout_prog(layout, seed: int, rows: bool, nodes: bool) -> np.ndarray:
    """K5/K6's programs with the conflict-free operand order undone (a lever
    measurement): each thread's row steps, or each level's node entries,
    in a random order. The reads, and so the parity, are unchanged; only
    which bank groups a quarter's eight threads hit at a step."""
    from celestia_tpu_torch.ops import xor_cuda

    rng = np.random.default_rng(seed)
    prog = layout.prog.copy()
    head, threads = xor_cuda.HEADER, xor_cuda.ENC_THREADS
    for g in range(layout.groups):
        p = prog[g]
        if nodes:
            for lv in range(layout.n_levels):
                count, off = p[head + lv], p[head + layout.n_levels + lv]
                entries = p[off: off + 2 * count].reshape(-1, 2)
                p[off: off + 2 * count] = entries[rng.permutation(len(entries))].reshape(-1)
        if rows:
            pairs, words = layout.row_program(g)
            pairs = pairs.copy()
            for t in range(threads):
                n = int(words[t] >> 16)
                slots = np.stack([pairs[:n, t] & 0xFFFF, pairs[:n, t] >> 16], 1).reshape(-1)
                slots = slots[rng.permutation(len(slots))].reshape(-1, 2)
                pairs[:n, t] = slots[:, 0] | (slots[:, 1] << 16)
            smem_words, _n, reg_off, _w, vec_off = (int(v) for v in p[:head])
            reg = min(layout.max_pairs, xor_cuda.REG_PAIRS)
            p[reg_off: reg_off + reg * threads] = pairs[:reg].reshape(-1)
            p[vec_off: smem_words] = pairs[reg:].reshape(-1, 4, threads).transpose(0, 2, 1).reshape(-1)
    return prog


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xor-table-out", default=None,
                    help="also write the measured dense/XOR routing table here")
    ap.add_argument("--crossover-out", default=None,
                    help="also write the App's measured gpu/native backend table here")
    ap.add_argument("--sass-out", default=None,
                    help="also write the SASS of K2, K3 and the tree kernel "
                         "(cuobjdump -sass) here")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run phase 6i (multi-GPU) alone")
    # phase 6i starts this script again as the ranks of its gloo group
    ap.add_argument("--multihost-worker", nargs=4, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.multihost_worker:
        rank, world, port, path = args.multihost_worker
        return multihost_worker(int(rank), int(world), int(port), path)

    from celestia_tpu_torch import da, faults, integrity
    from celestia_tpu_torch import namespace as ns
    from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_tpu_torch.app import calibration
    from celestia_tpu_torch.ops import _cuda, extend, gf256, merkle_cuda, nmt_cuda, nmt_host, rs
    from celestia_tpu_torch.ops import rs_cuda
    from celestia_tpu_torch.ops import sha256, sha256_cuda, transfers, xor_cuda, xor_schedule
    from celestia_tpu_torch.telemetry import metrics

    # the plain RS contraction is a float32 matmul: state full fp32 (its
    # 0/1 operands make every partial sum exact in TF32 as well)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    smi_line, card_name, power_limit = card()
    tag = {"card": card_name, "power_limit": power_limit}

    def emit(**kw) -> None:
        print(json.dumps({**kw, **tag}), flush=True)

    # wall seconds per phase, from its first line to the next phase's
    phase_marks: list[tuple[str, float]] = []

    def phase_start(name: str) -> None:
        phase_marks.append((name, time.perf_counter()))

    def as_i64(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.uint32:
            return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return t.to(torch.int64)

    max_err = dict.fromkeys(_cuda.LAUNCHES, 0)

    def same(name: str, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
        err = int((as_i64(a) - as_i64(b)).abs().max()) if a.numel() else 0
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{what}: kernel differs from its plain version (max abs err {err})")

    def dev_bytes(shape) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    # phase 2's namespace squares (the tree kernel's cases)
    def tree_square(k: int, kind: str) -> torch.Tensor:
        sq = rng.integers(0, 256, size=(k, k, SHARE_SIZE), dtype=np.uint8)
        subs = sorted(rng.integers(0, 200, size=(k * k, 10), dtype=np.uint8).tolist())
        nss = [ns.new_v0(bytes(sub)).bytes for sub in subs]
        if kind == "tail_padding":
            nss[k * k - max(1, k * k // 3):] = [ns.TAIL_PADDING_NAMESPACE.bytes] * max(1, k * k // 3)
        elif kind == "single_namespace":
            nss = [nss[0]] * (k * k)
        sq.reshape(k * k, SHARE_SIZE)[:, :NAMESPACE_SIZE] = np.frombuffer(
            b"".join(nss), np.uint8).reshape(k * k, NAMESPACE_SIZE)
        return torch.from_numpy(sq).to(dev)

    # bench.py's square (phases 6 to 7)
    def bench_square(kk: int, seed: int = 42) -> np.ndarray:
        """bench.py's build_square(kk, seed): sorted v0 namespaces."""
        r = np.random.default_rng(seed)
        flat = r.integers(0, 256, size=(kk * kk, SHARE_SIZE), dtype=np.uint8)
        subs = sorted(r.integers(0, 200, size=(kk * kk, 10), dtype=np.uint8).tolist())
        for i, sub in enumerate(subs):
            flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
        return flat.reshape(kk, kk, SHARE_SIZE)

    phase_start("1")
    # ---- phase 1: environment and build
    emit(phase="environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count(),
         sm_count=torch.cuda.get_device_properties(0).multi_processor_count,
         max_sm_clock=smi("clocks.max.sm"), crc32c=integrity.crc32c_implementation())
    t0 = time.perf_counter()
    lib = _cuda.library()
    emit(phase="build", seconds=time.perf_counter() - t0)
    for line in _cuda.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip(), file=sys.stderr)
    if args.mesh_only:
        return mesh_only(dev, emit, same, bench_square, tree_square, dev_bytes, smi_line)
    sha_kernels = ("leaf_digests2d_kernel", "sha256_words_kernel", "nmt_tree_kernel",
                   "dah_merkle_kernel")
    for name, report in ptxas_report(_cuda.build_log()).items():
        if any(f in name for f in ("encode2d_fft_kernel", "encode2d_xor_kernel",
                                   "decode_sweep_kernel", "ragged_gather_kernel",
                                   "assemble_square_kernel",
                                   *sha_kernels)):
            emit(phase="ptxas", kernel=name, **report)
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    for fragment in ("encode2d_fft_kernelILi128E", "decode_sweep_kernelILi256E", *sha_kernels):
        for kname, mix in sass_mix(sass, fragment).items():
            emit(phase="sass_mix", kernel=kname, instructions=sum(mix.values()),
                 ops=dict(mix.most_common(10)))
    # one pass of the decode sweep's work-item loop (its widest) at n = 256:
    # the lookups (LDS), their addresses and products (PRMT) and the rest
    decode_pass = block_loop_mix(sass, "decode_sweep_kernelILi256E")
    emit(phase="sass_mix", kernel="decode_sweep_kernel<256>", scope="one work item",
         instructions=sum(decode_pass.values()),
         per_pass=opcode_counts(decode_pass, ("LDS", "PRMT", "LOP3", "SHF", "IMAD", "IADD3",
                                              "LDG", "STG", "BAR")))
    emit(phase="occupancy", kernel="nmt_tree_kernel",
         blocks_per_sm=lib.celestia_nmt_tree_blocks_per_sm(0))
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            for fragment in sha_kernels:
                f.writelines(f"/*{a:04x}*/ {op} {arg};\n"
                             for a, op, arg in sass_lines(sass, fragment))
    # one SHA-256 block as compiled: a pass of K3's block loop (its 16 loads,
    # their addresses and the loop's own counter aside)
    k3_loop = block_loop_mix(sass, "sha256_words_kernel")
    sha_alu, sha_fma = sha_block_ops(k3_loop)
    check(1000 < sha_alu + sha_fma < 3000,
          f"K3's loop holds {sha_alu} + {sha_fma} SHA operations: not one compression")
    emit(phase="sha_block_count", kernel="sha256_words_kernel", alu_ops=sha_alu,
         fma_ops=sha_fma, loop_instructions=sum(k3_loop.values()),
         loop_ops=dict(k3_loop.most_common()))
    # one block's 64 rounds alone, the message schedule aside (the tree
    # kernel's rounds-only loop): the chain term of the SHA tree bounds
    r_loop = rounds_loop_mix(sass, "nmt_tree_kernel")
    round_alu, round_fma = sha_block_ops(r_loop)
    check(400 < round_alu < sha_alu,
          f"the tree kernel's rounds loop holds {round_alu} ALU operations: not 64 rounds")
    emit(phase="sha_rounds_count", kernel="nmt_tree_kernel", alu_ops=round_alu,
         fma_ops=round_fma, loop_instructions=sum(r_loop.values()),
         loop_ops=dict(r_loop.most_common()))
    t0 = time.perf_counter()
    xor_schedule.compile_schedule(128)  # host time at first use, before any timing
    emit(phase="xor_compile", k=128, seconds=time.perf_counter() - t0,
         **xor_schedule.schedule_stats(128))
    # K5/K6's layout at every rung of the routing table: the block groups
    # (no thread-block cluster: cluster size 1), the row segments, the row
    # program's step pairs, shared memory per block, and the padding of the
    # conflict-free operand order (zero-plane reads over real ones)
    for kk in TABLE_K:
        t0 = time.perf_counter()
        lay = xor_cuda.schedule_operands(kk, dev).layout
        emit(phase="xor_layout", k=kk, seconds=time.perf_counter() - t0, cluster_size=1,
             groups=lay.groups, segs=lay.segs, max_pairs=lay.max_pairs,
             register_pairs=min(lay.max_pairs, xor_cuda.REG_PAIRS), slots=lay.n_slots,
             smem_bytes_k6=lay.smem_bytes(hashed=False), smem_bytes_k5=lay.smem_bytes(hashed=True),
             reads_per_32_lanes=lay.reads, padded_reads_per_32_lanes=lay.padded_reads,
             padding=lay.padded_reads / lay.reads - 1)

    phase_start("2")
    # ---- phase 2: each kernel against its plain version on the card
    for nb in range(1, sha256.padded_length(600) // 64 + 1):
        lengths = [n for n in range(601) if sha256.padded_length(n) == 64 * nb]
        msgs = [rng.integers(0, 256, size=(4, n), dtype=np.uint8) for n in lengths]
        words = torch.cat([sha256_cuda.message_words(torch.from_numpy(m).to(dev))
                           for m in msgs], dim=1)
        got = sha256_cuda.sha256_words(words)
        same("sha256_words", got, sha256_cuda.sha_core_reference(words), f"K3 nb={nb}")
        digests = sha256.words_to_bytes(got.view(torch.int32).T).cpu().numpy()
        flat = [row for m in msgs for row in m]
        check(all(d.tobytes() == hashlib.sha256(m.tobytes()).digest()
                  for d, m in zip(digests, flat)), f"K3 nb={nb} differs from hashlib")
        for m in msgs:  # the byte-level entry, one length at a time
            d = sha256.sha256_fixed(torch.from_numpy(m).to(dev)).cpu().numpy()
            check(all(d[i].tobytes() == hashlib.sha256(m[i].tobytes()).digest()
                      for i in range(len(m))), f"sha256_fixed len={m.shape[1]}")
    for nb, batch in ((NODE_BLOCKS, 65536), (NODE_BLOCKS, 4096), (2, 512), (2, 1)):
        words = dev_bytes((16 * nb, batch * 4)).view(torch.int32).view(torch.uint32)
        words = words.reshape(16 * nb, batch)
        same("sha256_words", sha256_cuda.sha256_words(words),
             sha256_cuda.sha_core_reference(words), f"K3 ({16 * nb}, {batch})")
    emit(phase="kernel_vs_plain", kernel="sha256_words", lengths="0..600",
         tolerance=0, max_abs_err=max_err["sha256_words"])
    # K3's merkle form at every power-of-two k, one DAH and a batch of 3
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        for b in (1, 3):
            roots = dev_bytes((b, 4 * k, merkle_cuda.ROOT_SIZE))
            got = merkle_cuda.dah_merkle(roots)
            same("dah_merkle", got, merkle_cuda.dah_merkle_reference(roots),
                 f"dah_merkle k={k} B={b}")
            host = roots.cpu().numpy()
            check(all(got[i].cpu().numpy().tobytes() == hashlib_merkle(host[i])
                      for i in range(b)), f"dah_merkle k={k} B={b} differs from hashlib")
    emit(phase="kernel_vs_plain", kernel="dah_merkle", k=[1, 2, 4, 8, 16, 32, 64, 128],
         batches=[1, 3], tolerance=0, max_abs_err=max_err["dah_merkle"], hashlib=True)

    def identical(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and bool(torch.equal(a, b)), f"{what}: not byte-identical")

    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        x2 = dev_bytes((k, k * SHARE_SIZE))
        m2 = rs.encode_matrix(k, dev)
        ops = xor_cuda.schedule_operands(k, dev)
        parity, digests = rs_cuda.encode2d_hash(x2, m2)
        ref_parity, ref_digests = rs_cuda.encode2d_hash_reference(x2, m2)
        same("encode2d_hash", parity, ref_parity, f"K1 parity k={k}")
        same("encode2d_hash", digests, ref_digests, f"K1 digests k={k}")
        # K2 at the main path's two shapes: Q0 (k, k·512) and an EDS (2k, 2k·512)
        for rows in (k, 2 * k):
            xl = x2 if rows == k else dev_bytes((rows, rows * SHARE_SIZE))
            ns_pad = dev_bytes((rows, rows, rs_cuda.NS_PAD))
            same("leaf_digests2d", rs_cuda.leaf_digests2d(xl, ns_pad),
                 rs_cuda.leaf_digests2d_reference(xl, ns_pad), f"K2 ({rows}, {rows}*512)")
        p4 = rs_cuda.encode2d(x2, m2)
        same("encode2d", p4, rs_cuda.encode2d_reference(x2, m2), f"K4 k={k}")
        p5, d5 = xor_cuda.encode2d_xor_hash(x2, ops)
        ref5, ref_d5 = xor_cuda.encode2d_xor_hash_reference(x2, ops)
        same("encode2d_xor_hash", p5, ref5, f"K5 parity k={k}")
        same("encode2d_xor_hash", d5, ref_d5, f"K5 digests k={k}")
        p6 = xor_cuda.encode2d_xor(x2, ops)
        same("encode2d_xor", p6, xor_cuda.encode2d_xor_reference(x2, ops), f"K6 k={k}")
        # the FFT and XOR spellings are one code: their kernels agree
        identical(p5, parity, f"K5 parity vs K1, k={k}")
        identical(d5, digests, f"K5 digests vs K1, k={k}")
        identical(p6, p4, f"K6 vs K4, k={k}")
        identical(p4, parity, f"K4 vs K1, k={k}")
        emit(phase="kernel_vs_plain", k=k, tolerance=0,
             kernels=["encode2d_hash", "leaf_digests2d", "encode2d", "encode2d_xor_hash",
                      "encode2d_xor"],
             max_abs_err=max(max_err[n] for n in max_err if n != "sha256_words"),
             dense_equals_xor=True)
    # K2 at row counts that are no multiple of its 64-thread block
    for rows in (1, 3, 65):
        xl, ns_pad = dev_bytes((rows, 2 * SHARE_SIZE)), dev_bytes((rows, 2, rs_cuda.NS_PAD))
        same("leaf_digests2d", rs_cuda.leaf_digests2d(xl, ns_pad),
             rs_cuda.leaf_digests2d_reference(xl, ns_pad), f"K2 ({rows}, 1024)")
    emit(phase="kernel_vs_plain", kernel="leaf_digests2d", tolerance=0,
         shapes="(k, k*512) and (2k, 2k*512) for k = 1..128; (1|3|65, 1024)",
         max_abs_err=max_err["leaf_digests2d"])

    # K1 and K4 in the strided layouts the main path uses: the three
    # quadrant encodes in place in one (2k, 2k, 512) EDS (Q0 read from its
    # quadrant, Q3 reading Q2 where Q2 was written) and the roots-only
    # core's scratch layout (Q0 contiguous, row extends into unread
    # buffers); the whole EDS, untouched bytes included, equals the plain
    # version's. K2 with each cell's namespace read from the cell (Q0).
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        m2 = rs.encode_matrix(k, dev)
        eds = dev_bytes((2 * k, 2 * k, SHARE_SIZE))
        for layout in ("eds", "scratch"):
            for name, fn, ref in (
                    ("encode2d_hash", rs_cuda.encode_hash_into, rs_cuda.encode_hash_into_reference),
                    ("encode2d", rs_cuda.encode_into, rs_cuda.encode_into_reference)):
                a, b = eds.clone(), eds.clone()
                if layout == "eds":
                    qa, qb = rs_cuda.eds_quadrants(a, a[:k, :k]), rs_cuda.eds_quadrants(b, b[:k, :k])
                else:
                    qa = extend._scratch_quadrants(a[:k, :k].contiguous())
                    qb = extend._scratch_quadrants(b[:k, :k].contiguous())
                for i, ((sa, da_), (sb, db_)) in enumerate(zip(qa, qb)):
                    out, want = fn(sa, da_, m2), ref(sb, db_, m2)
                    if out is not None:
                        same(name, out, want, f"{name} digests {layout} quadrant {i} k={k}")
                    same(name, da_, db_, f"{name} parity {layout} quadrant {i} k={k}")
                same(name, a, b, f"{name} {layout} square k={k}")
        x2 = eds[:k, :k].contiguous().reshape(k, k * SHARE_SIZE)
        same("leaf_digests2d", rs_cuda.leaf_digests2d(x2, rs_cuda.own_namespaces(x2)),
             rs_cuda.leaf_digests2d_reference(x2, rs_cuda.own_namespaces(x2)),
             f"K2 own namespaces k={k}")
        emit(phase="strided_vs_plain", k=k, tolerance=0, layouts=["eds", "scratch"],
             kernels=["encode2d_hash", "encode2d", "leaf_digests2d (own namespaces)"],
             strides_bytes={"column_extend": [2 * k * SHARE_SIZE, SHARE_SIZE],
                            "row_extend": [SHARE_SIZE, 2 * k * SHARE_SIZE]},
             max_abs_err=max(max_err["encode2d_hash"], max_err["encode2d"],
                             max_err["leaf_digests2d"]))

    # the tree kernel on random digests in the fused route's layout (Q1 and
    # Q3 [col, row] tensors passed transposed, the namespaces a view of the
    # shares): the roots of both families (an extend's call), and the row
    # roots with every row level (eds_row_levels_device's), against the
    # plain level loop, under tree_square's namespaces
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        for kind in ("random", "tail_padding", "single_namespace"):
            grid = dev_bytes((2 * k, 2 * k, 32)).view(torch.int32).view(torch.uint32)
            d1t = grid[:k, k:].transpose(0, 1).contiguous()
            d3t = grid[k:, k:].transpose(0, 1).contiguous()
            quads = (grid[:k, :k].contiguous(), d1t.transpose(0, 1),
                     grid[k:, :k].contiguous(), d3t.transpose(0, 1))
            q0_ns = tree_square(k, kind)[..., :NAMESPACE_SIZE]
            roots, _ = nmt_cuda.nmt_tree(quads, q0_ns)
            ref_roots, _ = nmt_cuda.nmt_tree_reference(quads, q0_ns)
            same("nmt_tree", roots, ref_roots, f"nmt_tree roots k={k} {kind}")
            rows, levels = nmt_cuda.nmt_tree(quads, q0_ns, keep_levels=True)
            ref_rows, ref_levels = nmt_cuda.nmt_tree_reference(quads, q0_ns, keep_levels=True)
            same("nmt_tree", rows, ref_rows, f"nmt_tree row roots k={k} {kind}")
            same("nmt_tree", levels, ref_levels, f"nmt_tree row levels k={k} {kind}")
            identical(rows[0], roots[0], f"nmt_tree row roots of both calls, k={k} {kind}")
        emit(phase="kernel_vs_plain", kernel="nmt_tree", k=k, tolerance=0,
             squares=["random", "tail_padding", "single_namespace"],
             outputs=["roots (rows, columns)", "row roots and row levels"],
             max_abs_err=max_err["nmt_tree"])
    torch.cuda.synchronize()

    phase_start("3")
    # ---- phase 3: the reference DAH hashes through the port's main path
    def oracle_square(count: int) -> np.ndarray:
        ns1 = ns.new_v0(b"\x01" * ns.NAMESPACE_VERSION_ZERO_ID_SIZE)
        share = ns1.bytes + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)
        return np.frombuffer(share * count, np.uint8).reshape(count, SHARE_SIZE)

    def host_dah(rows: np.ndarray, cols: np.ndarray) -> bytes:
        return da.DataAvailabilityHeader([r.tobytes() for r in rows],
                                         [c.tobytes() for c in cols]).hash()

    oracles = [
        ("MIN", 1, da.tail_padding_share(), MIN_DAH),
        ("TYPICAL", 2, None, TYPICAL_DAH),
        ("MAX", 128, None, MAX_DAH),
    ]
    for rname in ROUTES:
        for label, k, share, expect in oracles:
            flat = (np.frombuffer(share, np.uint8)[None] if share is not None
                    else oracle_square(k * k))
            with pinned(rname):
                if label == "MIN":
                    got = da.min_data_availability_header(dev).hash().hex()
                else:
                    got = da.new_data_availability_header(
                        da.extend_shares(flat, dev)).hash().hex()
                _eds, rows, cols, dah = extend.extend_and_root_device(
                    flat.reshape(k, k, SHARE_SIZE), dev)
            check(got == expect, f"{label} DAH on {rname}: {got} != {expect}")
            check(dah.tobytes().hex() == expect == host_dah(rows, cols).hex(),
                  f"{label} device DAH on {rname} differs from the host DAH")
            emit(phase="oracle", route=rname, name=label, k=k, dah=got)

    phase_start("4")
    # ---- phase 4: realistic squares, the main path, kernel route vs plain route
    def realistic(k: int, pad_tail: int) -> np.ndarray:
        flat = rng.integers(0, 256, size=(k * k, SHARE_SIZE), dtype=np.uint8)
        body = k * k - pad_tail
        subs = sorted(rng.integers(0, 200, size=(body, 10), dtype=np.uint8).tolist())
        for i, sub in enumerate(subs):
            flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
        tail = np.frombuffer(ns.TAIL_PADDING_NAMESPACE.bytes, np.uint8)
        flat[body:, :NAMESPACE_SIZE] = tail
        return flat.reshape(k, k, SHARE_SIZE)

    def host_oracle_roots(q0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        k = q0.shape[0]
        eds = np.zeros((2 * k, 2 * k, SHARE_SIZE), np.uint8)
        eds[:k, :k] = q0
        for i in range(k):
            eds[i, k:] = gf256.leopard_encode(q0[i])
            eds[k:, i] = gf256.leopard_encode(q0[:, i])
        for i in range(k, 2 * k):
            eds[i, k:] = gf256.leopard_encode(eds[i, :k])
        parity = ns.PARITY_SHARES_NAMESPACE.bytes

        def root(cells, axis):
            return nmt_host.nmt_root([
                (c[:NAMESPACE_SIZE].tobytes() if axis < k and j < k else parity) + c.tobytes()
                for j, c in enumerate(cells)])
        rows = np.stack([np.frombuffer(root(eds[i], i), np.uint8) for i in range(2 * k)])
        cols = np.stack([np.frombuffer(root(eds[:, j], j), np.uint8) for j in range(2 * k)])
        return rows, cols

    main_sq = realistic(128, 0)
    encoders = {enc for _f, _x, enc in ROUTES.values()}
    launches: dict[str, int] = {}
    main: dict[str, tuple] = {}
    for rname, (_f, _x, enc) in ROUTES.items():
        with pinned(rname):
            torch.cuda.synchronize()
            _cuda.reset_launches()
            r_eds = da.extend_shares(main_sq.reshape(-1, SHARE_SIZE), dev)
            r_dah = da.new_data_availability_header(r_eds)
            r_levels = extend.eds_row_levels_device(r_eds.device_data, dev)
            torch.cuda.synchronize()
            counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route=rname, k=main_sq.shape[0],
             entry="da.extend_shares+new_data_availability_header+eds_row_levels_device",
             launches=counts, dah=r_dah.hash().hex())
        for kname in (enc, "leaf_digests2d", "nmt_tree"):
            check(counts[kname] > 0, f"the {rname} main path launched {kname} no time")
        # one tree launch for the extend, one for the row levels; no K3
        check(counts["nmt_tree"] == 2, f"the {rname} main path launched nmt_tree "
                                       f"{counts['nmt_tree']} times, expected 2")
        check(counts["sha256_words"] == 0, f"the {rname} main path launched sha256_words")
        for other in encoders - {enc}:
            check(counts[other] == 0, f"the {rname} main path launched {other}")
        launches[enc] = counts[enc]
        if rname == "fused-dense":
            launches["leaf_digests2d"] = counts["leaf_digests2d"]
            launches["nmt_tree"] = counts["nmt_tree"]
        main[rname] = (r_eds, r_dah, r_levels)
    main_eds, main_dah, main_levels = main["fused-dense"]
    # the device DAH: K3's merkle form, one launch over the 4k axis roots
    # (its main_path line, with the DAH's aten ops and the entry's wall ms,
    # comes with the timing of phase 7)
    with pinned("fused-dense"):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        dah_dev = extend.extend_and_root_device(main_sq, dev)[3]
        torch.cuda.synchronize()
        dah_counts = dict(_cuda.LAUNCHES)
    check(dah_dev.tobytes() == main_dah.hash(), "extend_and_root_device DAH != main path DAH")
    check(dah_counts["dah_merkle"] == 1 and dah_counts["sha256_words"] == 0
          and dah_counts["nmt_tree"] == 1,
          f"extend_and_root_device launched {dah_counts}: expected dah_merkle 1, "
          f"sha256_words 0, nmt_tree 1")
    launches["dah_merkle"] = dah_counts["dah_merkle"]
    launches["sha256_words"] = dah_counts["sha256_words"]

    squares = [("realistic", 64, realistic(64, 0)), ("tail_padding", 64, realistic(64, 700)),
               ("realistic", 128, main_sq), ("tail_padding", 128, realistic(128, 3000))]
    for label, k, sq in squares:
        with pinned("fused-dense"):
            got = extend.extend_and_root_device(sq, dev)
            plain = extend.extend_and_root_device(sq, dev, kernels=extend.PLAIN)
            rows, cols = extend.roots_device(sq, dev)
        for part, a, b in zip(("eds", "rows", "cols", "dah"), got, plain):
            check(np.array_equal(a, b), f"{label} k={k}: kernel route {part} != plain route")
        check(got[3].tobytes() == host_dah(got[1], got[2]), f"{label} k={k}: device DAH != host DAH")
        levels = extend.eds_row_levels_device(got[0], dev)
        plain_levels = extend.eds_row_levels_device(got[0], dev, kernels=extend.PLAIN)
        check(len(levels) == len(plain_levels) == int(np.log2(2 * k)) + 1, "level count")
        for a, b in zip(levels, plain_levels):
            check(np.array_equal(a, b), f"{label} k={k}: row levels differ from plain")
        check(np.array_equal(levels[-1][:, 0], got[1]), f"{label} k={k}: levels' roots")
        check(np.array_equal(rows, got[1]) and np.array_equal(cols, got[2]), "roots_device")
        e_rows, e_cols = extend.eds_roots_device(got[0], dev)
        check(np.array_equal(e_rows, got[1]) and np.array_equal(e_cols, got[2]),
              "eds_roots_device")
        if k == 64:
            h_rows, h_cols = host_oracle_roots(sq)
            check(np.array_equal(rows, h_rows) and np.array_equal(cols, h_cols),
                  f"{label} k=64: roots differ from the host oracle")
        # every other route: its kernels equal its plain versions and the
        # fused dense route
        for rname in ROUTES:
            if rname == "fused-dense":
                continue
            with pinned(rname):
                r_got = extend.extend_and_root_device(sq, dev)
                r_plain = extend.extend_and_root_device(sq, dev, kernels=extend.PLAIN)
                r_rows, r_cols = extend.roots_device(sq, dev)
            for part, a, b, c in zip(("eds", "rows", "cols", "dah"), r_got, r_plain, got):
                check(np.array_equal(a, b), f"{label} k={k} {rname}: kernel {part} != plain")
                check(np.array_equal(a, c), f"{label} k={k} {rname}: {part} != fused dense")
            check(np.array_equal(r_rows, rows) and np.array_equal(r_cols, cols),
                  f"{label} k={k} {rname}: roots_device")
        if sq is main_sq:
            for rname, (r_eds, r_dah, r_levels) in main.items():
                check(np.array_equal(r_eds.data, got[0]), f"main path EDS on {rname}")
                check(r_dah.hash() == got[3].tobytes(), f"main path DAH on {rname}")
                for a, b in zip(r_levels, levels):
                    check(np.array_equal(a, b), f"main path row levels on {rname}")
        emit(phase="route_vs_plain", square=label, k=k, routes=list(ROUTES),
             dah=got[3].tobytes().hex(), host_oracle=(k == 64))

    phase_start("5")
    # ---- phase 5: the block path around the kernels (roots-only core,
    # batched roots, staging, integrity, sliced reads)
    def wall_ms(fn, reps: int = REPS) -> float:
        """Median host time of ``fn`` until the card is done, after two
        warm-up calls."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def cuda_event_ms(fn, reps: int = REPS) -> float:
        """Median CUDA-event time of one call, after two warm-up calls."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    sq64 = squares[0][2]
    # the roots-only core (no EDS assembled) against the resident path's
    # roots and the plain route, on every route
    for rname in ROUTES:
        with pinned(rname):
            for kk, sq in ((64, sq64), (128, main_sq)):
                rows, cols = extend.roots_device(sq, dev)
                _eds, r_rows, r_cols = extend.extend_roots_device_resident(sq, dev)
                p_rows, p_cols = extend._rows_cols_only(
                    torch.from_numpy(sq).to(dev), rs.encode_matrix(kk, dev), kernels=extend.PLAIN)
                check(np.array_equal(rows, r_rows) and np.array_equal(cols, r_cols),
                      f"roots_device != extend_roots_device_resident on {rname} k={kk}")
                check(np.array_equal(rows, p_rows.cpu().numpy())
                      and np.array_equal(cols, p_cols.cpu().numpy()),
                      f"the roots-only core != its plain route on {rname} k={kk}")
        emit(phase="roots_only", route=rname, k=[64, 128], equals_resident_roots=True,
             equals_plain_route=True)

    # batched roots (the replay verifier's entry): squares with the same
    # sorted namespaces and other bytes, byte-identical to one roots_device
    # a square, lists and stacked; ms per square beside roots_device's
    def variant(sq: np.ndarray) -> np.ndarray:
        out = sq.copy()
        out[..., NAMESPACE_SIZE:] = rng.integers(0, 256, size=out[..., NAMESPACE_SIZE:].shape,
                                                 dtype=np.uint8)
        return out

    batched_launches: dict[tuple[int, int], dict[str, int]] = {}  # (k, B) -> one call's
    for kk, base in ((64, sq64), (128, main_sq)):
        pool = [variant(base) for _ in range(8)]
        singles = [extend.roots_device(sq, dev) for sq in pool]
        for b in (1, 2, 4, 8):
            for form, shares in (("list", pool[:b]), ("stacked", np.stack(pool[:b]))):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                rows, cols = extend.batched_roots_device(shares, dev)
                torch.cuda.synchronize()
                batched_launches[(kk, b)] = {n: c for n, c in _cuda.LAUNCHES.items() if c}
                check(all(np.array_equal(rows[i], singles[i][0])
                          and np.array_equal(cols[i], singles[i][1]) for i in range(b)),
                      f"batched_roots_device ({form}) B={b} k={kk} != roots_device")
            batched = wall_ms(lambda s=pool[:b]: extend.batched_roots_device(s, dev), reps=5)
            single = wall_ms(lambda s=pool[:b]: [extend.roots_device(q, dev) for q in s], reps=5)
            emit(phase="batched", k=kk, batch=b, chunk=extend._batch_chunk(kk, b),
                 identical=True, launches=batched_launches[(kk, b)], ms_per_square=batched / b,
                 roots_device_ms_per_square=single / b)

    # staging: the k = 128 square to the card, until the card has it
    nbytes = main_sq.nbytes
    staged = {}
    stage_ms = {}
    for c in (1, 2, 4, 8):
        def put(c=c):
            staged[f"chunks_{c}"] = transfers.device_put_chunked(main_sq, dev, site="smoke.staging",
                                                                 chunks=c)
        stage_ms[f"chunks_{c}"] = wall_ms(put)
    src_pageable = torch.from_numpy(main_sq)
    src_pinned = src_pageable.pin_memory()

    def put_pageable():
        staged["pageable_to"] = src_pageable.to(dev)

    def put_pinned():
        staged["pinned_to"] = src_pinned.to(dev, non_blocking=True)

    stage_ms["pageable_to"] = wall_ms(put_pageable)
    stage_ms["pinned_to"] = wall_ms(put_pinned)
    # the host's share: the square into pinned memory, by numpy (one
    # thread) and by torch (its thread pool, as device_put_chunked does)
    pinned_host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    stage_ms["host_copy_to_pinned_numpy"] = wall_ms(
        lambda: np.copyto(pinned_host.numpy(), main_sq.reshape(-1)))
    stage_ms["host_copy_to_pinned_torch"] = wall_ms(
        lambda: pinned_host.copy_(src_pageable.reshape(-1)))
    check(np.array_equal(staged["pageable_to"].cpu().numpy(), main_sq),
          "staging: the pageable copy differs")
    for name, t in staged.items():
        check(torch.equal(t, staged["pageable_to"]), f"staging {name}: bytes differ")
    emit(phase="staging", k=128, bytes=nbytes, ms=stage_ms,
         gb_per_s={n: nbytes / (v * 1e6) for n, v in stage_ms.items()},
         identical=True, auto_chunks=transfers._auto_chunks(nbytes, 128),
         host_threads=torch.get_num_threads())
    # the staging levers end to end: fused dense roots_device at k = 128
    # with the chunk rule (transfers._auto_chunks), with one chunk, and with
    # the monolithic pageable copy in place of the staging, in turns
    def pageable_stage(arr, d):
        return torch.from_numpy(np.asarray(arr)).to(d)

    rule, stage = transfers._auto_chunks, extend._stage
    levers = {"chunk_rule": (rule, stage), "one_chunk": (lambda _n, _r: 1, stage),
              "pageable_to": (rule, pageable_stage)}
    lever_ms: dict[str, list[float]] = {name: [] for name in levers}
    try:
        with pinned("fused-dense"):
            for rep in range(2 + E2E_REPS):
                for name, (chunk_rule, stage_fn) in levers.items():
                    transfers._auto_chunks, extend._stage = chunk_rule, stage_fn
                    t = time.perf_counter()
                    extend.roots_device(main_sq, dev)  # ends in a D2H copy of the roots
                    if rep >= 2:
                        lever_ms[name].append((time.perf_counter() - t) * 1e3)
    finally:
        transfers._auto_chunks, extend._stage = rule, stage
    emit(phase="staging_levers", k=128, route="fused-dense", entry="roots_device",
         median_ms={n: statistics.median(v) for n, v in lever_ms.items()},
         q1_q3_ms={n: statistics.quantiles(v, n=4)[::2] for n, v in lever_ms.items()},
         samples=E2E_REPS)

    # integrity: the syndrome through K4 against its plain version, clean
    # and with one flipped parity bit, at sampled (q = 4) and full (q = 2k)
    eds_main = main_eds.device_data
    for level, q in (("sampled", 4), ("full", 256)):
        draw = random.Random(SEED)
        ri = np.asarray(draw.sample(range(256), q), dtype=np.int32)
        ci = np.asarray(draw.sample(range(256), q), dtype=np.int32)
        bad = eds_main.clone()
        bad[int(ri[0]), 200, 7:8].bitwise_xor_(4)  # a parity cell of a sampled row
        counts = {}
        for label, sq in (("clean", eds_main), ("flipped", bad)):
            got = int(integrity.syndrome(sq, ri, ci))
            want = int(integrity.syndrome(sq, ri, ci, rs_cuda.encode_into_reference))
            check(got == want, f"syndrome {level} {label}: K4 {got} != plain {want}")
            counts[label] = got
        check(counts["clean"] == 0 and counts["flipped"] > 0, f"syndrome {level}: {counts}")
        emit(phase="integrity", level=level, k=128, q=q, counts=counts,
             device_ms=cuda_event_ms(lambda: integrity.syndrome(eds_main, ri, ci)),
             plain_ms=cuda_event_ms(
                 lambda: integrity.syndrome(eds_main, ri, ci, rs_cuda.encode_into_reference),
                 reps=3),
             wall_ms=wall_ms(lambda: int(integrity.syndrome(eds_main, ri, ci))))
    # the drills: a flipped extend output must raise with the plain count,
    # a transient transfer.chunk flip heal on its retry, a persistent one raise
    integrity.configure("full", q=4, seed=SEED)
    try:
        with faults.inject(faults.rule("device.extend.output", "bitflip"), seed=SEED):
            try:
                extend.extend_roots_device_resident(main_sq, dev)
                fail("a device.extend.output bitflip passed the full audit")
            except integrity.IntegrityError as err:
                caught = err
        draw = random.Random(SEED)
        rows_all, cols_all = draw.sample(range(256), 256), draw.sample(range(256), 256)
        plain_count = int(integrity.syndrome(torch.from_numpy(caught.eds).to(dev), rows_all,
                                             cols_all, rs_cuda.encode_into_reference))
        plain_count += integrity.host_recompute_mismatch(caught.eds, 128)
        check(caught.mismatches == plain_count > 0,
              f"the drill's mismatches {caught.mismatches} != the plain count {plain_count}")
        retries = metrics.get_counter("transfer_retry_total", site="smoke.drill", direction="h2d")
        with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
            healed = transfers.device_put_chunked(main_sq, dev, site="smoke.drill", chunks=4)
        check(np.array_equal(healed.cpu().numpy(), main_sq), "the healed upload differs")
        check(metrics.get_counter("transfer_retry_total", site="smoke.drill",
                                  direction="h2d") == retries + 1, "no retry was counted")
        with faults.inject(faults.rule("transfer.chunk", "bitflip"), seed=SEED):
            try:
                transfers.device_put_chunked(main_sq, dev, site="smoke.drill", chunks=4)
                fail("a persistent transfer.chunk bitflip did not raise")
            except integrity.IntegrityError:
                pass
    finally:
        integrity.configure("off")
    emit(phase="integrity_drill", k=128, level="full", extend_output_mismatches=caught.mismatches,
         plain_count=plain_count, transfer_chunk_transient="healed",
         transfer_chunk_persistent="raised")

    # sliced reads of the device-resident k = 128 EDS against a full fetch
    def d2h(site: str) -> float:
        return metrics.get_counter("transfer_bytes", site=site, direction="d2h")

    full = transfers.device_get_chunked(eds_main, site="smoke.full")
    check(np.array_equal(full, eds_main.cpu().numpy()), "the chunked full fetch differs")
    idx = [0, 1, 127, 128, 255]
    for i in idx:
        check(np.array_equal(transfers.eds_row(eds_main, i), full[i]), f"row {i}")
        check(np.array_equal(transfers.eds_col(eds_main, i), full[:, i]), f"column {i}")
        check(np.array_equal(transfers.eds_share(eds_main, i, 255 - i), full[i, 255 - i]),
              f"cell {i}")
    check(np.array_equal(transfers.eds_rows_batch(eds_main, idx), full[idx]), "row batch")
    pts = [(i, 255 - i) for i in idx]
    check(np.array_equal(transfers.eds_cells_batch(eds_main, pts), full[idx, [255 - i for i in idx]]),
          "cell batch")
    resident = da.ExtendedDataSquare.from_device(eds_main, 128)
    check(resident.row(7) == [full[7, j].tobytes() for j in range(256)]
          and resident.share(200, 3) == full[200, 3].tobytes() and resident._data is None,
          "ExtendedDataSquare sliced reads")
    emit(phase="sliced_reads", k=128, reads=len(idx), full_fetch_bytes=d2h("smoke.full"),
         bytes={site: d2h(site) for site in ("eds.row", "eds.col", "eds.share",
                                             "eds.rows_batch", "eds.cells_batch")},
         row_read_ms=wall_ms(lambda: transfers.eds_row(eds_main, 5)),
         cell_read_ms=wall_ms(lambda: transfers.eds_share(eds_main, 5, 9)),
         full_fetch_ms=wall_ms(lambda: transfers.device_get_chunked(eds_main, site="smoke.t"),
                               reps=3))

    phase_start("6")
    # ---- phase 6: EDS repair, the repair-after-extend path of a catching-up
    # node (BASELINE config 4): bench.py's square and masks at k = 128 and 64
    from celestia_tpu_torch.ops import repair, repair_cuda

    # the decode sweep at every power of two k to 32: one random 25% mask
    # (the first of its seed's draws that a repair can undo), every sweep
    # against the plain version, the swept square the extended one
    from celestia_tpu_torch.da.repair import UnrepairableError

    small_sweeps = 0
    for kk in (1, 2, 4, 8, 16, 32):
        with pinned("fused-dense"):
            s_eds = extend.extend_roots_device_resident(bench_square(kk), dev)[0]
        w = 2 * kk
        draw = np.random.default_rng(SEED + kk)
        while True:
            present = np.ones((w, w), dtype=bool)
            present.reshape(-1)[draw.choice(w * w, size=max(1, w * w // 4), replace=False)] = False
            try:
                s_plans = repair.plan_sweeps(present, kk)
                break
            except UnrepairableError:
                continue
        a = torch.where(torch.from_numpy(present).to(dev)[..., None], s_eds, 0)
        b = a.clone()
        for i, plan in enumerate(repair._stage_plans(s_plans, dev)):
            repair_cuda.sweep(a, plan)
            repair_cuda.sweep_reference(b, plan)
            same("decode_sweep", a, b, f"decode sweep {i} k={kk} (25% mask)")
        identical(a, s_eds, f"the swept square k={kk} (25% mask)")
        small_sweeps += len(s_plans)
    emit(phase="kernel_vs_plain", kernel="decode_sweep", k=[1, 2, 4, 8, 16, 32],
         masks="one random 25% mask each", sweeps=small_sweeps, tolerance=0,
         max_abs_err=max_err["decode_sweep"])

    repair_timed = {}  # k: (repaired square, a row sweep of a random mask, its plan)
    for kk in (128, 64):
        with pinned("fused-dense"):
            r_eds, r_rows, r_cols = extend.extend_roots_device_resident(bench_square(kk), dev)
        truth = r_eds.clone()
        truth_host = truth.cpu().numpy()
        row_roots = [r.tobytes() for r in r_rows]
        col_roots = [c.tobytes() for c in r_cols]
        masks = repair_masks(kk)
        plans = {label: repair.plan_sweeps(present, kk) for label, present in masks}
        n_sweeps = sum(len(v) for v in plans.values())
        n_columns = sum(p.transpose for v in plans.values() for p in v)
        check(all(len(plans[label]) == 1 for label, _p in masks[:4]) and n_columns > 0,
              f"k={kk}: the random masks plan one row sweep each, the last mask a column sweep")
        # the kernel against its plain version, sweep by sweep on the same input
        for label, present in masks:
            a = torch.where(torch.from_numpy(present).to(dev)[..., None], r_eds, 0)
            b = a.clone()
            for i, plan in enumerate(repair._stage_plans(plans[label], dev)):
                repair_cuda.sweep(a, plan)
                repair_cuda.sweep_reference(b, plan)
                same("decode_sweep", a, b, f"decode sweep {i} "
                     f"({'column' if plan.transpose else 'row'}) k={kk} {label}")
            identical(a, truth, f"the swept square k={kk} {label}")
        emit(phase="kernel_vs_plain", kernel="decode_sweep", k=kk,
             masks=[label for label, _p in masks], sweeps=n_sweeps, column_sweeps=n_columns,
             tolerance=0, max_abs_err=max_err["decode_sweep"])
        # the main path: the resident cycle (sweeps, the roots recomputed on
        # the card, compared with the DAH), then repair_device (square in and
        # out through the host), each with the counts from 0
        torch.cuda.synchronize()
        _cuda.reset_launches()
        fixed = [repair.repair_resident_verified(r_eds, present, row_roots, col_roots, dev)
                 for _label, present in masks]
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route="fused-dense", k=kk, entry="repair_resident_verified",
             masks=len(masks), sweeps=n_sweeps, launches=counts)
        check(counts["decode_sweep"] == n_sweeps,
              f"k={kk}: {counts['decode_sweep']} decode sweeps launched, {n_sweeps} planned")
        # the verify's roots: one leaf pass (K2) and one tree launch a repair
        check(counts["nmt_tree"] == counts["leaf_digests2d"] == len(masks),
              f"k={kk}: the verify launched nmt_tree {counts['nmt_tree']} times")
        check(all(counts[name] == 0 for name in counts
                  if name not in ("decode_sweep", "nmt_tree", "leaf_digests2d")),
              f"k={kk}: the resident repair launched {counts}")
        for (label, _p), f in zip(masks, fixed):
            identical(f, truth, f"repair_resident_verified k={kk} {label}")
        if kk == 128:
            launches["decode_sweep"] = counts["decode_sweep"]
        srcs = [np.where(present[..., None], truth_host, 0) for _label, present in masks]
        torch.cuda.synchronize()
        _cuda.reset_launches()
        got = [repair.repair_device(src, present, dev) for src, (_l, present) in zip(srcs, masks)]
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route="fused-dense", k=kk, entry="repair_device",
             masks=len(masks), sweeps=n_sweeps, launches=counts)
        check(counts["decode_sweep"] == n_sweeps and sum(counts.values()) == n_sweeps,
              f"k={kk}: repair_device launched {counts}; {n_sweeps} sweeps planned, no tree")
        for (label, _p), g in zip(masks, got):
            check(np.array_equal(g, truth_host), f"repair_device k={kk} {label}: not the EDS")
        # a flipped root must raise; the caller's square never changes; run()
        # returns the same bytes each time
        for which in ("row", "column"):
            bad = list(row_roots if which == "row" else col_roots)
            bad[3] = bytes([bad[3][0] ^ 1]) + bad[3][1:]
            try:
                repair.repair_resident_verified(
                    r_eds, masks[0][1], bad if which == "row" else row_roots,
                    bad if which == "column" else col_roots, dev)
                fail(f"k={kk}: a flipped {which} root passed the verify")
            except ValueError as err:
                check(f"repaired {which} roots do not match DAH" in str(err), str(err))
        run, _n = repair.stage_resident_repair(r_eds, masks[-1][1], dev)
        first = run().clone()
        identical(run(), first, f"k={kk}: run() twice")
        identical(first, truth, f"k={kk}: run()")
        identical(r_eds, truth, f"k={kk}: the caller's resident EDS changed")
        # timing, the masks in turn as bench.py cycles them
        turn = iter(range(10**9))

        def cycled(fn):
            return lambda: fn(next(turn) % 4)

        emit(phase="repair", k=kk, masks=4, erased=0.25,
             plan_ms=wall_ms(cycled(lambda i: repair.plan_sweeps(masks[i][1], kk))),
             repair_device_ms=wall_ms(cycled(
                 lambda i: repair.repair_device(srcs[i], masks[i][1], dev))),
             resident_cycle_ms=wall_ms(cycled(lambda i: repair.repair_resident_verified(
                 r_eds, masks[i][1], row_roots, col_roots, dev))))
        if kk == 128:
            # the locator lever: the plan's dgemm through torch (the port) or
            # through numpy's BLAS (the JAX package's spelling), whose threads
            # keep spinning after the call and slow the host copies that come
            # next, the next call's included. So each spelling runs as a
            # block (2 warm-up calls, then REPS), the blocks in turns twice
            locator = gf256._error_locator_logs_batch
            erased = (~masks[0][1]).astype(np.int64)
            check(np.array_equal(numpy_locator(erased), locator(erased)),
                  "the two spellings of the error locator differ")
            entries = {"repair_device": lambda i: repair.repair_device(srcs[i], masks[i][1], dev),
                       "resident_cycle": lambda i: repair.repair_resident_verified(
                           r_eds, masks[i][1], row_roots, col_roots, dev)}
            lever_ms: dict[str, list[float]] = {}
            try:
                for _turn in range(2):
                    for lever, fn in (("torch_matmul", locator), ("numpy_dgemm", numpy_locator)):
                        gf256._error_locator_logs_batch = fn
                        for entry, call in entries.items():
                            for rep in range(2 + REPS // 2):
                                t = time.perf_counter()
                                call(rep % 4)
                                torch.cuda.synchronize()
                                if rep >= 2:
                                    lever_ms.setdefault(f"{entry}:{lever}", []).append(
                                        (time.perf_counter() - t) * 1e3)
            finally:
                gf256._error_locator_logs_batch = locator
            emit(phase="repair_levers", k=kk, samples=2 * (REPS // 2),
                 median_ms={n: statistics.median(v) for n, v in lever_ms.items()},
                 q1_q3_ms={n: statistics.quantiles(v, n=4)[::2] for n, v in lever_ms.items()})
        plan0 = plans[masks[0][0]][0]
        repair_timed[kk] = (truth.clone(), truth.clone(), repair._stage_plans([plan0], dev)[0],
                            plan0)
        if kk == 128:
            # a device.repair.output bitflip must raise under the full audit
            integrity.configure("full", q=4, seed=SEED)
            try:
                with faults.inject(faults.rule("device.repair.output", "bitflip"), seed=SEED):
                    try:
                        repair.repair_device(srcs[0], masks[0][1], dev)
                        fail("a device.repair.output bitflip passed the full audit")
                    except integrity.IntegrityError as err:
                        check(err.site == "device.repair.output" and err.mismatches > 0,
                              f"the repair drill raised at {err.site}")
                        repair_drill = err.mismatches
            finally:
                integrity.configure("off")
            emit(phase="integrity_drill", k=kk, level="full", site="device.repair.output",
                 mismatches=repair_drill)

    phase_start("6b")
    # ---- phase 6b: serving reads, DAS samples off the paged device EDS cache
    from celestia_tpu_torch import proof, tracing
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.eds_cache import PagedEdsCache, ResidentEdsCache
    from celestia_tpu_torch.ops import ragged, ragged_cuda

    def pages_of(eds_t: torch.Tensor, rpp: int) -> list[torch.Tensor]:
        return [eds_t[lo:lo + rpp].clone() for lo in range(0, eds_t.shape[0], rpp)]

    # (a) the gather kernel against its plain version at every power of two k
    # (8-row pages), one descriptor and a group with duplicates; a group of
    # 300 at k = 128 (the full parameter table); more descriptors and pages
    # than one table holds; and two geometries in one group
    pick = np.random.default_rng(SEED + 1)
    cases = 0
    for kk in (1, 2, 4, 8, 16, 32, 64, 128):
        pages = pages_of(dev_bytes((2 * kk, 2 * kk, SHARE_SIZE)), 8)
        n = 300 if kk == 128 else 40
        slots = [int(s) for s in pick.integers(len(pages), size=n)]
        rows = [int(r) for r in pick.integers(pages[0].shape[0], size=n)]
        slots, rows = slots + slots[:7], rows + rows[:7]  # duplicates
        for s, r in ((slots[:1], rows[:1]), (slots, rows)):
            same("ragged_gather", ragged_cuda.ragged_gather(pages, s, r),
                 ragged_cuda.gather_rows_reference(pages, s, r),
                 f"ragged_gather k={kk} n={len(s)}")
            cases += 1
    many = pages_of(dev_bytes((2 * (ragged_cuda.MAX_PAGES + 128), 2, SHARE_SIZE)), 2)
    n_many = ragged_cuda.MAX_DESCS + 1000
    slots = [int(s) for s in pick.integers(len(many), size=n_many)]
    rows = [int(r) for r in pick.integers(2, size=n_many)]
    plan = ragged_cuda.plan_launches(slots, rows)
    before = _cuda.LAUNCHES["ragged_gather"]
    got = ragged_cuda.ragged_gather(many, slots, rows)
    check(len(plan) >= 2 and _cuda.LAUNCHES["ragged_gather"] - before == len(plan),
          f"{n_many} descriptors over {len(many)} pages: {len(plan)} planned launches, "
          f"{_cuda.LAUNCHES['ragged_gather'] - before} made")
    same("ragged_gather", got, ragged_cuda.gather_rows_reference(many, slots, rows),
         f"ragged_gather over {len(plan)} launches")
    geo = {kk: pages_of(dev_bytes((2 * kk, 2 * kk, SHARE_SIZE)), 3) for kk in (8, 16)}
    # every page once (full 3-row pages and each k's short tail page), then
    # 20 more, alternating k
    picks = [(kk, i) for kk in (8, 16) for i in range(len(geo[kk]))]
    picks += [((8, 16)[t % 2], None) for t in range(20)]
    descs, want = [], []
    for kk, i in picks:
        page = geo[kk][int(pick.integers(len(geo[kk]))) if i is None else i]
        r = int(pick.integers(page.shape[0]))
        descs.append((page, r, 2 * kk))
        want.append(page[r].cpu().numpy())
    shapes = {tuple(d[0].shape) for d in descs}
    before = _cuda.LAUNCHES["ragged_gather"]
    got = ragged.gather_rows(descs)
    check(_cuda.LAUNCHES["ragged_gather"] - before == len(shapes) == 4,
          f"gather_rows over {len(shapes)} geometries launched "
          f"{_cuda.LAUNCHES['ragged_gather'] - before} times")
    check(all(g.tobytes() == w.tobytes() for g, w in zip(got, want)),
          "gather_rows over mixed geometries differs from the rows sliced one by one")
    emit(phase="kernel_vs_plain", kernel="ragged_gather", k=[1, 2, 4, 8, 16, 32, 64, 128],
         cases=cases, table_launches=len(plan), descriptors=n_many, pages=len(many),
         geometries=len(shapes), tolerance=0, max_abs_err=max_err["ragged_gather"])

    # (b) full width: four heights of bench.py's square at k = 128 in a
    # node's default paged cache (128 MiB, 4 heights, 8-row pages: 32 a
    # height, every page resident), a crowd of 256 samples uniform over them,
    # one ragged_gather launch and nothing else
    sk, width = SERVING_K, 2 * SERVING_K
    heights = SERVING_HEIGHTS
    node = Node(device=dev)
    cache = node._eds_cache
    check((cache.device_byte_budget, cache.max_heights, cache.rows_per_page)
          == (128 << 20, 4, 8), f"the node's default cache is {cache.stats()}")
    host_eds, host_rows = {}, {}
    for h in heights:
        with pinned("fused-dense"):
            eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
        host_eds[h], host_rows[h] = eds.data, eds.row_roots()
        cache.put(h, eds)  # ExtendBlock retention's call
        del eds
    check(all(len(cache.get(h).pages) == width // cache.rows_per_page for h in heights)
          and cache.stats()["page_demotes"] == 0, f"paging: {cache.stats()}")
    host_provers: dict[int, dict] = {h: {} for h in heights}

    def host_docs(payloads) -> list:
        """Every document built on the host from the fetched EDS."""
        return [proof.das_sample_docs({i: [host_eds[h][i, c].tobytes() for c in range(width)]},
                                      [(i, j)], sk, provers=host_provers[h])[0]
                for h, i, j in payloads]

    def serve(which: str, srv, payloads) -> list:
        """The crowd through sample_batch_ragged with the counts from 0: one
        ragged_gather launch (one geometry) and nothing else."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = srv.sample_batch_ragged(payloads)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache=which,
             samples=len(payloads), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the {which} crowd launched {counts}: ragged_gather once, nothing else")
        check(out == host_docs(payloads), f"the {which} crowd's documents differ from the host's")
        return out, counts

    def crowd_ms(srv, seeds) -> list[float]:
        """Host ms per sample of sample_batch_ragged, a fresh crowd a call."""
        out = []
        for s in seeds:
            p = serving_crowd(s, heights, width, SERVING_SAMPLES)
            t = time.perf_counter()
            srv.sample_batch_ragged(p)
            out.append((time.perf_counter() - t) * 1e3 / len(p))
        return out

    def stages_of(srv, payloads) -> dict:
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            srv.sample_batch_ragged(payloads)
            wall = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        return {"wall_ms": wall, **{name: s * 1e3 for name, s in sink.data.items()}}

    crowd0 = serving_crowd(SEED, heights, width, SERVING_SAMPLES)
    docs, counts = serve("full_width", node, crowd0)
    launches["ragged_gather"] = counts["ragged_gather"]
    g_case = gather_case(lambda h: [p.dev for p in cache.get(h).pages], crowd0, 8)
    same("ragged_gather", ragged_cuda.ragged_gather(*g_case),
         ragged_cuda.gather_rows_reference(*g_case), "ragged_gather at the crowd's bucket")
    full_ms = crowd_ms(node, range(SEED + 10, SEED + 15))
    full_stages = stages_of(node, serving_crowd(SEED + 20, heights, width, SERVING_SAMPLES))
    one = [(i, j) for _h, i, j in serving_crowd(SEED + 30, (1,), width, 64)]
    one_ms = []
    for s in range(5):
        coords = [(i, j) for _h, i, j in serving_crowd(SEED + 40 + s, (1,), width, 64)]
        t = time.perf_counter()
        node.sample_batch(1, coords)
        one_ms.append((time.perf_counter() - t) * 1e3 / len(coords))
    check(node.sample_batch(1, one) == host_docs([(1, i, j) for i, j in one]),
          "sample_batch at one height differs from the host's documents")
    # every document verifies against the block's DAH (block_dah materializes
    # each paged square on the host, so it comes after the timed crowds)
    verified = 0
    for h in heights:
        check(node.block_dah(h).row_roots == host_rows[h], f"block_dah({h}) row roots")
    for (h, i, j), doc in zip(crowd0, docs):
        share = bytes.fromhex(doc["share"])
        p = doc["proof"]
        pr = proof.NmtRangeProof(p["start"], p["end"], [bytes.fromhex(x) for x in p["nodes"]],
                                 p["tree_size"])
        pr.verify_inclusion(node.block_dah(h).row_roots[i],
                            [da.erasured_leaf_namespace(i, j, share, sk)], [share])
        verified += 1
    emit(phase="serving", part="full_width", k=sk, heights=len(heights),
         samples=SERVING_SAMPLES, unique_rows=len(g_case[1]), unique_pages=len(g_case[0]),
         verified=verified, ms_per_sample=statistics.median(full_ms), ms_per_sample_all=full_ms,
         stages=full_stages, sample_batch_ms_per_sample=statistics.median(one_ms),
         sample_batch_samples=64, stats=cache.stats())

    # (c) the same squares and crowd at a budget of 8 pages: demotions and
    # fault-ins, the same bytes, the device bytes back inside the budget (and
    # one page) after each call, and each square's memory freed once its
    # handle is dropped: the pages are buffers of their own
    page_bytes = 8 * width * SHARE_SIZE
    tight = Node(device=dev)
    tight._eds_cache = tc = PagedEdsCache(device_byte_budget=SERVING_TIGHT_PAGES * page_bytes,
                                          device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mem = []
    for h in heights:
        with pinned("fused-dense"):
            eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        tc.put(h, eds)
        torch.cuda.synchronize()
        put = torch.cuda.memory_allocated()
        del eds
        torch.cuda.synchronize()
        dropped = torch.cuda.memory_allocated()
        mem.append({"height": h, "square_mib": (held - base) / 2**20,
                    "after_put_mib": (put - base) / 2**20,
                    "after_drop_mib": (dropped - base) / 2**20,
                    "resident_mib": tc.device_bytes() / 2**20})
        check(put - dropped >= 2 * sk * width * SHARE_SIZE,
              f"height {h}: dropping the square freed {(put - dropped) / 2**20} MiB, not "
              f"its {2 * sk * width * SHARE_SIZE / 2**20}: the cache holds its storage")
        check(dropped - base <= tc.device_bytes() + page_bytes,
              f"height {h}: {(dropped - base) / 2**20} MiB allocated for "
              f"{tc.device_bytes() / 2**20} MiB of resident pages")
        check(tc.device_bytes() <= tc.device_byte_budget + page_bytes, "over budget after put")
    torch.cuda.reset_peak_memory_stats()
    peak0 = torch.cuda.memory_allocated()
    tight_docs, _counts = serve("tight_budget", tight, crowd0)
    peak = torch.cuda.max_memory_allocated() - peak0
    check(tight_docs == docs, "the tight budget changed the documents")
    st = tc.stats()
    check(st["page_demotes"] > 0 and st["page_faultins"] > 0 and st["page_corrupt"] == 0,
          f"the tight budget did not churn: {st}")
    check(tc.device_bytes() <= tc.device_byte_budget + page_bytes,
          f"{tc.device_bytes()} device bytes after the crowd, budget {tc.device_byte_budget}")
    tight_ms = crowd_ms(tight, range(SEED + 10, SEED + 12))
    check(tc.device_bytes() <= tc.device_byte_budget + page_bytes, "over budget after the crowds")
    tight_stages = stages_of(tight, serving_crowd(SEED + 21, heights, width, SERVING_SAMPLES))
    # one page's demotion (fetch + CRC32C) and fault-in (CRC32C + upload,
    # until it has landed), each through the cache's own leg, median of 5
    resident = next(p for p in tc._pages if p.dev is not None and not p.pins)
    demoted = next(p for p in tc._pages if p.dev is None and p.host is not None)

    def leg_ms(fn) -> float:
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    demote_ms = leg_ms(lambda: tc._demote(resident, resident.dev))
    faultin_ms = leg_ms(lambda: tc._fault_in(demoted))
    crc_ms = leg_ms(lambda: integrity.crc32c(demoted.host))
    emit(phase="serving", part="tight_budget", k=sk, budget_pages=SERVING_TIGHT_PAGES,
         samples=SERVING_SAMPLES, ms_per_sample=statistics.median(tight_ms),
         ms_per_sample_all=tight_ms, stages=tight_stages, peak_crowd_mib=peak / 2**20,
         memory=mem, demote_ms_per_page=demote_ms, faultin_ms_per_page=faultin_ms,
         crc32c_ms_per_page=crc_ms, page_mib=page_bytes / 2**20, stats=tc.stats())

    # (d) a cache.faultin bitflip drill: sample_batch_ragged invalidates the
    # one height the IntegrityError names and answers the rest
    drill = serving_crowd(SEED + 50, heights, width, SERVING_SAMPLES)
    with faults.inject(faults.rule("cache.faultin", "bitflip", times=1), seed=SEED):
        drilled = tight.sample_batch_ragged(drill)
    gone = [h for h in heights if h not in tc]
    check(len(gone) == 1 and tc.stats()["page_corrupt"] == 1,
          f"the drill invalidated {gone}, {tc.stats()['page_corrupt']} corrupt pages")
    check(all(d is None if h in gone else d == w
              for (h, _i, _j), d, w in zip(drill, drilled, host_docs(drill))),
          "the drill's other heights were not answered as the host answers them")
    emit(phase="integrity_drill", site="cache.faultin", entry="Node.sample_batch_ragged",
         healed=gone, answered=sum(d is not None for d in drilled), samples=len(drill))

    # (e) a ResidentEdsCache node: its provers come from the device's row
    # levels, one K2 and one tree launch, proofs equal to the host's
    res = Node(device=dev)
    res._eds_cache = ResidentEdsCache()
    with pinned("fused-dense"):
        res._eds_cache.put(1, da.extend_shares(bench_square(sk, 42).reshape(-1, SHARE_SIZE), dev))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    rdocs = res.sample_batch(1, one)
    first_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    emit(phase="main_path", entry="Node._row_provers", cache="resident", k=sk, launches=counts)
    check(counts["leaf_digests2d"] == 1 and counts["nmt_tree"] == 1 and sum(counts.values()) == 2,
          f"the resident node's provers launched {counts}: K2 once and nmt_tree once")
    check(res._prover_cache[1][0] is not None, "the resident node built its provers on the host")
    check(rdocs == host_docs([(1, i, j) for i, j in one]),
          "the resident node's documents differ from the host's")
    res_ms = []
    for s in range(5):
        coords = [(i, j) for _h, i, j in serving_crowd(SEED + 60 + s, (1,), width, 64)]
        t = time.perf_counter()
        res.sample_batch(1, coords)
        res_ms.append((time.perf_counter() - t) * 1e3 / len(coords))
    emit(phase="serving", part="resident", k=sk, samples=64, first_call_ms=first_ms,
         ms_per_sample=statistics.median(res_ms))

    def cuda_ms(fn, inner: int = 1, reps: int = REPS) -> float:
        """Median over `reps` samples of the CUDA-event time of `inner`
        back-to-back calls, per call. A call's host work (wrapper checks,
        allocation, launch) overlaps the device only across calls, so a
        kernel shorter than its launch path reads as the launch path."""
        fn()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def host_ms(fn, reps: int = REPS) -> float:
        fn()
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()  # ends in a D2H copy of the roots, so the device is done
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    phase_start("6c")
    # ---- phase 6c: the proposer's path from transactions (bench.py config 8b):
    # square construction, the blobs staged in the arena, the square
    # assembled on the card from it, the roots-only core, the DAH
    from celestia_tpu_torch import square as square_pkg
    from celestia_tpu_torch.app import proposal
    from celestia_tpu_torch.ops import assemble, assemble_cuda
    from celestia_tpu_torch.ops.blob_pool import DeviceBlobArena, blob_key
    from celestia_tpu_torch.shares import to_bytes

    def assembly_tensors(case: dict) -> tuple:
        """A case's kernel inputs on the card, in the layout assembled_roots
        stages (the arena's bytes first)."""
        meta = np.stack([case[f] for f in ("blob_start", "blob_nshares", "blob_off",
                                           "blob_len")]).astype(np.int32)
        sparse = np.stack([case["host_pos"], case["host_row"]]).astype(np.int32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            case["arena"], case["host_shares"], meta, case["ns_table"], sparse))

    # (a) the kernel against its plain version at every power of two k, on
    # every input family
    asm_k = [1, 2, 4, 8, 16, 32, 64, 128]
    cases = 0
    for kk in asm_k:
        for fi, fam in enumerate(ASSEMBLY_FAMILIES):
            a = assembly_tensors(assembly_case(kk, SEED + 31 * kk + fi, fam))
            same("assemble_square", assemble_cuda.assemble_square(*a, kk),
                 assemble.assemble_square_reference(*a, kk), f"assemble_square k={kk} {fam}")
            cases += 1
    asm_ptxas = [r for name, r in ptxas_report(_cuda.build_log()).items()
                 if "assemble_square_kernel" in name]
    check(len(asm_ptxas) == 1, "no ptxas report of the assembly kernel")
    check(asm_ptxas[0].get("spill_store_bytes", 0) == 0
          and asm_ptxas[0].get("spill_load_bytes", 0) == 0,
          f"the assembly kernel spills: {asm_ptxas[0]}")
    emit(phase="kernel_vs_plain", kernel="assemble_square", k=asm_k,
         families=list(ASSEMBLY_FAMILIES), cases=cases, tolerance=0,
         max_abs_err=max_err["assemble_square"], **asm_ptxas[0])

    # (b) the main path at full width: build the square, stage the blobs,
    # assemble and root it, with the counts from 0
    def h2d_bytes(site: str) -> float:
        return metrics.get_counter("transfer_bytes", site=site, direction="h2d")

    txs = proposal_txs()
    t = time.perf_counter()
    p_square, kept, builder = square_pkg.build_ex(txs, 1, PROPOSAL_K)
    build_ms = (time.perf_counter() - t) * 1e3
    pk = square_pkg.square_size(len(p_square))
    check(pk == PROPOSAL_K and len(kept) == PROPOSAL_BLOBS,
          f"config 8b's square is k = {pk} with {len(kept)} of {PROPOSAL_BLOBS} txs")
    p_arr = np.frombuffer(b"".join(to_bytes(p_square)), np.uint8).reshape(pk, pk, SHARE_SIZE)
    blobs = [b.data for _s, b in builder.blob_layout()]
    put_ms = []
    for _rep in range(5):  # a fresh arena each time, so every blob is staged
        p_arena = DeviceBlobArena(device=dev)
        torch.cuda.synchronize()
        before = h2d_bytes("arena.stage")
        t = time.perf_counter()
        p_arena.put_many(blobs)
        p_arena.ready()
        torch.cuda.synchronize()
        put_ms.append((time.perf_counter() - t) * 1e3)
        arena_bytes = h2d_bytes("arena.stage") - before
    check(p_arena.resident_bytes() == sum(map(len, blobs)),
          f"{p_arena.resident_bytes()} of {sum(map(len, blobs))} blob bytes resident")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    before = h2d_bytes("proposal.stage")
    p_dah = proposal.assembled_proposal_dah(p_arena, p_square, builder, pk, dev)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    staged = h2d_bytes("proposal.stage") - before
    emit(phase="main_path", entry="assembled_proposal_dah", k=pk, launches=counts,
         proposal_stage_bytes=staged, arena_stage_bytes=arena_bytes)
    want = {"assemble_square": 1, "leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1}
    check(p_dah is not None and counts == {**dict.fromkeys(counts, 0), **want},
          f"assembled_proposal_dah launched {counts}: {want} expected")
    check(staged < 1 << 20, f"{staged} bytes staged for the proposal: tens of KB expected")
    launches["assemble_square"] = counts["assemble_square"]
    rd_rows, rd_cols = extend.roots_device(p_arr, dev)
    h_rows, h_cols = host_oracle_roots(p_arr)
    check(p_dah.row_roots == [r.tobytes() for r in rd_rows] == [r.tobytes() for r in h_rows]
          and p_dah.column_roots == [c.tobytes() for c in rd_cols]
          == [c.tobytes() for c in h_cols] and p_dah.hash() == host_dah(h_rows, h_cols),
          "the assembled proposal DAH differs from roots_device's or the host NMT DAH")
    # the reference DAHs again, through the assembly: no blob, every cell a
    # row of the deduplicated host table
    no_arena = torch.zeros(4096, dtype=torch.uint8, device=dev)
    empty = np.zeros(0, np.int32)
    for label, kk, share, expect in oracles:
        flat = (np.frombuffer(share, np.uint8)[None] if share is not None
                else oracle_square(kk * kk))
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        o_rows, o_cols = extend.assembled_roots(
            no_arena, uniq, np.arange(kk * kk, dtype=np.int32), inv.reshape(-1).astype(np.int32),
            empty, empty, empty, empty, np.zeros((0, NAMESPACE_SIZE), np.uint8), kk)
        got = host_dah(o_rows, o_cols).hex()
        check(got == expect, f"{label} DAH through the assembly: {got} != {expect}")
        emit(phase="oracle", route="assembled", name=label, k=kk, dah=got)
    # host times of the proposal: the content key of every blob (the JAX
    # contract hashes each blob on each proposal), the metadata, and the
    # entry against roots_device on the same square, in turns
    p_inputs = proposal.proposal_inputs(p_arena, p_square, builder, pk)
    key_ms = host_ms(lambda: [blob_key(b) for b in blobs])
    inputs_ms = host_ms(lambda: proposal.proposal_inputs(p_arena, p_square, builder, pk))
    p_e2e: dict[str, list[float]] = {"assembled_proposal_dah": [], "roots_device": []}
    p_entries = {
        "assembled_proposal_dah":
            lambda: proposal.assembled_proposal_dah(p_arena, p_square, builder, pk, dev),
        "roots_device": lambda: extend.roots_device(p_arr, dev)}
    for rep in range(2 + E2E_REPS):  # two warm-up rounds
        for entry, fn in p_entries.items():
            t = time.perf_counter()
            fn()  # ends in a D2H copy of the roots
            if rep >= 2:
                p_e2e[entry].append((time.perf_counter() - t) * 1e3)
    asm_args = (*assembly_tensors({"arena": p_arena.arena.cpu().numpy(), **p_inputs}), pk)
    check(torch.equal(assemble_cuda.assemble_square(*asm_args),
                      torch.from_numpy(p_arr).to(dev)),
          "the assembled config-8b square differs from the host-built square")
    asm_bytes = assembly_bytes(pk, p_inputs["blob_len"], len(p_inputs["host_shares"]))
    emit(phase="proposal", k=pk, blobs=len(blobs), blob_bytes=sum(map(len, blobs)),
         host_cells=len(p_inputs["host_pos"]), host_table_rows=len(p_inputs["host_shares"]),
         proposal_stage_bytes=staged, arena_stage_bytes=arena_bytes, build_ex_ms=build_ms,
         put_many_ms=statistics.median(put_ms), put_many_all_ms=put_ms, blob_key_ms=key_ms,
         proposal_inputs_ms=inputs_ms,
         **{f"{e}_ms": statistics.median(v) for e, v in p_e2e.items()},
         **{f"{e}_q1_q3_ms": statistics.quantiles(v, n=4)[::2] for e, v in p_e2e.items()},
         samples=E2E_REPS, assembly_bytes=asm_bytes, dah=p_dah.hash().hex())

    phase_start("6d")
    # ---- phase 6d: the durable store tier. A node with a home persists the
    # four heights of phase 6b (bench.py's square at k = 128, seeds 42-45) to
    # its BlockStore, restarts, and serves the 256-sample crowd from disk
    from celestia_tpu_torch.store import BlockStore

    t_phase = time.perf_counter()
    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-store-"))
    try:
        # (a) persist: each height's square put as retention puts it, then
        # _persist_block_eds: one K2 and one tree launch (the row levels),
        # one fetch of the square at store.persist, the DAH from the roots
        # the square carries
        snode = Node(device=dev, home=home)
        check(snode.store is not None and len(snode.store) == 0 and snode._eds_cache.store is snode.store,
              "a node with a home opened no empty store below its cache")
        eds_bytes = 2 * sk * width * SHARE_SIZE
        persist, pre_dah = [], {}
        for h in heights:
            with pinned("fused-dense"):
                eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
            cols = eds.col_roots()
            snode._eds_cache.put(h, eds)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            fetched = metrics.get_counter("transfer_bytes", site="store.persist", direction="d2h")
            sink = tracing.push_stage_sink()
            try:
                t = time.perf_counter()
                snode._persist_block_eds(h, eds)
                ms = (time.perf_counter() - t) * 1e3
            finally:
                tracing.pop_stage_sink()
            counts = dict(_cuda.LAUNCHES)
            emit(phase="main_path", entry="Node._persist_block_eds", k=sk, height=h,
                 launches=counts)
            check(counts["leaf_digests2d"] == 1 and counts["nmt_tree"] == 1
                  and sum(counts.values()) == 2,
                  f"persisting height {h} launched {counts}: K2 once and nmt_tree once")
            fetched = metrics.get_counter("transfer_bytes", site="store.persist",
                                          direction="d2h") - fetched
            check(fetched == eds_bytes, f"persisting height {h} fetched {fetched} B, not the "
                  f"square's {eds_bytes} once")
            entry = snode.store.entry(h)
            check(entry is not None and entry.levels_len > 0 and entry.k == sk
                  and entry.rows_per_page == 8 and entry.page_count == width // 8,
                  f"height {h}'s store entry: {entry}")
            stored = snode.store.read_dah(h)
            pre_dah[h] = json.dumps(snode.block_dah(h).to_json(), sort_keys=True)
            check(json.dumps(stored, sort_keys=True) == pre_dah[h],
                  f"height {h}: the stored DAH differs from block_dah's bytes")
            check(stored == {"row_roots": [r.hex() for r in host_rows[h]],
                             "column_roots": [c.hex() for c in cols]},
                  f"height {h}: the stored DAH differs from the extend's roots")
            persist.append({"height": h, "ms": ms,
                            **{f"{n}_ms": v * 1e3 for n, v in sink.data.items()},
                            "file_bytes": entry.path.stat().st_size})
            del eds
        emit(phase="store", part="persist", k=sk, heights=len(heights), rows_per_page=8,
             square_bytes=eds_bytes, per_height=persist,
             ms_per_height=statistics.median(p["ms"] for p in persist), stats=snode.store.stats())
        # before the restart: the same crowd as phase 6b, the same documents
        check(snode.sample_batch_ragged(crowd0) == docs,
              "the persisting node's crowd differs from phase 6b's documents")
        check(all(snode._prover_cache[h][0] is not None for h in heights),
              "the persisting node's provers did not come from the stored levels")
        del snode

        # (b) restart: a fresh node over the same home re-indexes (deep: every
        # page's CRC) and serves the crowd from disk. Its provers come from
        # the stored levels: ragged_gather once and no K2 or tree launch
        t = time.perf_counter()
        rnode = Node(device=dev, home=home)
        reindex_ms = (time.perf_counter() - t) * 1e3
        check(rnode.store.heights() == list(heights)
              and rnode.store.stats()["reindex_skipped"] == {},
              f"the restart re-indexed {rnode.store.stats()}")
        rc = rnode._eds_cache
        torch.cuda.synchronize()
        _cuda.reset_launches()
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            cold = rnode.sample_batch_ragged(crowd0)
            cold_ms = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache="store_restart",
             samples=len(crowd0), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the restart crowd launched {counts}: ragged_gather once, nothing else")
        check(cold == docs, "the restarted node's documents differ from the pre-restart crowd's")
        st = rc.stats()
        check(st["heights_from_store"] == len(heights) and st["page_store_loads"] > 0
              and st["page_corrupt"] == 0, f"the restart crowd read no page off disk: {st}")
        check(all(rnode._prover_cache[h][0] is not None for h in heights),
              "the restarted node's provers did not come from the stored levels")
        g_case = gather_case(lambda h: [p.dev for p in rc.get(h).pages], crowd0, 8)
        same("ragged_gather", ragged_cuda.ragged_gather(*g_case),
             ragged_cuda.gather_rows_reference(*g_case),
             "ragged_gather on the store-loaded pages")
        check(all(json.dumps(rnode.block_dah(h).to_json(), sort_keys=True) == pre_dah[h]
                  for h in heights), "the restarted node's DAH bytes differ from the pre-restart ones")
        warm_ms = crowd_ms(rnode, range(SEED + 10, SEED + 15))
        page = rc.get(1).pages[0]
        read_ms = leg_ms(lambda: rnode.store.read_page(1, 0))
        page_host = rnode.store.read_page(1, 0)[0]
        page_crc_ms = leg_ms(lambda: integrity.crc32c(page_host))
        check(page.host is None, "a page of the default budget kept a host copy")
        store_faultin_ms = leg_ms(lambda: rc._fault_in(page))  # read, both CRCs, upload
        emit(phase="store", part="restart", k=sk, heights=len(heights), reindex_ms=reindex_ms,
             samples=SERVING_SAMPLES, cold_ms=cold_ms, cold_ms_per_sample=cold_ms / len(crowd0),
             cold_stages={n: v * 1e3 for n, v in sink.data.items()},
             warm_ms_per_sample=statistics.median(warm_ms), warm_ms_per_sample_all=warm_ms,
             read_page_ms=read_ms, crc32c_ms_per_page=page_crc_ms,
             store_faultin_ms_per_page=store_faultin_ms, page_mib=page_bytes / 2**20,
             stats=rc.stats(), store=rnode.store.stats())
        emit(phase="store", part="vs_paged", k=sk, samples=SERVING_SAMPLES,
             restart_cold_ms_per_sample=cold_ms / len(crowd0),
             restart_warm_ms_per_sample=statistics.median(warm_ms),
             paged_full_width_ms_per_sample=statistics.median(full_ms),
             paged_tight_ms_per_sample=statistics.median(tight_ms))

        # (c) the restart at a host budget of 8 pages (and a device budget of
        # 8, so pages demote to the host at all): host copies spill and pages
        # come off disk again, the documents unchanged
        tnode = Node(device=dev, home=home)
        tnode._eds_cache = tsc = PagedEdsCache(
            device_byte_budget=SERVING_TIGHT_PAGES * page_bytes,
            host_byte_budget=SERVING_TIGHT_PAGES * page_bytes, store=tnode.store, device=dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            tight_cold = tnode.sample_batch_ragged(crowd0)
            tight_cold_ms = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache="store_tight",
             samples=len(crowd0), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the tight restart crowd launched {counts}: ragged_gather once, nothing else")
        check(tight_cold == docs, "the tight budget changed the restarted node's documents")
        # a second crowd reads spilled pages back off disk: its documents
        # are the default-budget node's for the same crowd
        again = serving_crowd(SEED + 10, heights, width, SERVING_SAMPLES)
        t = time.perf_counter()
        tight_again = tnode.sample_batch_ragged(again)
        tight_again_ms = (time.perf_counter() - t) * 1e3
        check(tight_again == rnode.sample_batch_ragged(again),
              "the spilled pages read back changed the documents")
        st = tsc.stats()
        check(st["page_spills"] > 0 and st["page_store_loads"] > len(g_case[0])
              and st["page_corrupt"] == 0 and st["host_bytes"] <= tsc.host_byte_budget,
              f"the tight restart did not spill and read back: {st}")
        emit(phase="store", part="tight_budget", k=sk, budget_pages=SERVING_TIGHT_PAGES,
             host_budget_pages=SERVING_TIGHT_PAGES, samples=SERVING_SAMPLES,
             cold_ms_per_sample=tight_cold_ms / len(crowd0),
             cold_stages={n: v * 1e3 for n, v in sink.data.items()},
             ms_per_sample=tight_again_ms / len(again), stats=tsc.stats())

        # (d) the drills. A store.read bitflip raises IntegrityError at the
        # store and at the node refuses the one height it struck: that height
        # answers None, the others as before
        dnode = Node(device=dev, home=home)
        sdc0 = metrics.get_counter("sdc_detected_total", site="store.read")
        corrupt0 = metrics.get_counter("store_read_corrupt_total")
        with faults.inject(faults.rule("store.read", "bitflip", times=1), seed=SEED):
            with contextlib.suppress(integrity.IntegrityError):
                dnode.store.read_page(1, 0)
                fail("a store.read bitflip did not raise IntegrityError")
        check(metrics.get_counter("sdc_detected_total", site="store.read") == sdc0 + 1
              and metrics.get_counter("store_read_corrupt_total") == corrupt0 + 1,
              "the store.read bitflip was not counted")
        with faults.inject(faults.rule("store.read", "bitflip", times=1), seed=SEED):
            drilled = dnode.sample_batch_ragged(crowd0)
        poisoned = sorted(dnode._store_refused)
        check(len(poisoned) == 1 and poisoned[0] not in dnode._eds_cache,
              f"the store.read drill refused {poisoned}")
        check(all(d is None if h in poisoned else d == w
                  for (h, _i, _j), d, w in zip(crowd0, drilled, docs)),
              "the drill's other heights were not answered as before")
        check(metrics.get_counter("sdc_detected_total", site="store.read") == sdc0 + 2
              and metrics.get_counter("store_read_corrupt_total") == corrupt0 + 2,
              "the node's store.read drill was not counted")
        emit(phase="integrity_drill", site="store.read", entry="Node.sample_batch_ragged",
             refused=poisoned, answered=sum(d is not None for d in drilled), samples=len(crowd0))
        # a truncated file and a garbage file: quarantined by the next re-index
        last = rnode.store.entry(heights[-1])
        with open(last.path, "r+b") as f:
            f.truncate(last.page_offset(last.page_count // 2))
        (home / "store" / "99.ctps").write_bytes(b"not a store file")
        skipped0 = {r: metrics.get_counter("store_reindex_skipped_total", reason=r)
                    for r in ("truncated", "bad_header")}
        qnode = Node(device=dev, home=home)
        report = qnode.store.stats()
        check(qnode.store.heights() == list(heights[:-1])
              and report["reindex_skipped"] == {"truncated": 1, "bad_header": 1}
              and all(metrics.get_counter("store_reindex_skipped_total", reason=r) == v + 1
                      for r, v in skipped0.items()),
              f"the damaged store re-indexed as {report}")
        check(qnode.sample_batch(heights[-1], [(0, 0)]) == [None],
              "the quarantined height answered")
        # the port's store CLI: verify exits 1 on the damaged store and 0 on
        # a clean copy of its sound heights (the two runs side by side)
        clean = home / "clean"
        (clean / "store").mkdir(parents=True)
        for h in heights[:-1]:
            shutil.copy(rnode.store.entry(h).path, clean / "store")
        t = time.perf_counter()
        runs = [subprocess.Popen(
            [sys.executable, "-m", "celestia_tpu_torch.cli", "store", "verify", "--home", str(d)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for d in (home, clean)]
        (rc_bad, doc_bad), (rc_ok, doc_ok) = [
            (r.returncode, json.loads(out) if out.strip() else None)
            for r, (out, _err) in ((r, r.communicate(timeout=300)) for r in runs)]
        cli_ms = (time.perf_counter() - t) * 1e3
        check(rc_bad == 1 and doc_bad is not None
              and doc_bad["skipped_files"] == {"truncated": 1, "bad_header": 1},
              f"store verify on the damaged store: exit {rc_bad}, {doc_bad}")
        check(rc_ok == 0 and doc_ok is not None and doc_ok["heights"] == len(heights) - 1
              and doc_ok["skipped_files"] == {}, f"store verify on the clean store: exit {rc_ok}, {doc_ok}")
        emit(phase="integrity_drill", site="store.reindex", entry="Node(home=...)",
             skipped=report["reindex_skipped"], cli_verify_damaged=rc_bad, cli_verify_clean=rc_ok,
             cli_ms=cli_ms, phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(home, ignore_errors=True)

    phase_start("6e")
    # ---- phase 6e: the chain. bench.py config 8b's block signed by the
    # port's own keys, checked and delivered by the port's state machine on
    # the host, then its square built, assembled and rooted on the card
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch import crypto, inclusion
    from celestia_tpu_torch.tx import sign_doc_bytes
    from celestia_tpu_torch.x.blob.types import new_msg_pay_for_blobs

    t_phase = time.perf_counter()
    c_key = crypto.PrivateKey.from_secret(CHAIN_KEY_SECRET)
    c_pub, c_addr = c_key.public_key(), c_key.bech32_address()
    c_blobs = config_8b_blobs()
    c_msgs = [new_msg_pay_for_blobs(c_addr, b) for b in c_blobs]
    c_txs, c_raws, sign_ms = [], [], []
    for seq, (msg, b) in enumerate(zip(c_msgs, c_blobs)):
        t = time.perf_counter()
        tx, raw = sign_chain_tx(c_key, msg, b, seq)
        sign_ms.append((time.perf_counter() - t) * 1e3)
        c_txs.append(tx)
        c_raws.append(raw)
    commitment_ms, verify_ms = [], []
    for tx, b in zip(c_txs, c_blobs):
        t = time.perf_counter()
        inclusion.create_commitment(b)
        commitment_ms.append((time.perf_counter() - t) * 1e3)
        doc = sign_doc_bytes(tx.body_bytes(), tx.auth_info_bytes(), CHAIN_ID, 0)
        t = time.perf_counter()
        ok = crypto.verify_signature(c_pub, doc, tx.signatures[0])
        verify_ms.append((time.perf_counter() - t) * 1e3)
        check(ok, "a port-signed tx does not verify")
    # genesis, then CheckTx of the 60 on one persistent check branch
    c_store = chain_genesis(c_addr)
    c_check = c_store.branch()
    c_times: dict[str, list[float]] = {}
    checked = [chain_check(c_check, raw, c_times) for raw in c_raws]
    refused = [r for r in checked if r[0] != 0]
    check(not refused, f"{len(refused)} of {len(c_raws)} txs refused at CheckTx: {refused[:2]}")
    # the refusals: a 61st tx reusing sequence 59, a blob flipped after
    # signing, and a signature with one bit flipped (directly, and as a
    # 61st tx with the right sequence through the ante)
    reused = chain_check(c_check, sign_chain_tx(c_key, c_msgs[0], c_blobs[0], 59)[1])
    check(reused[0] != 0 and "account sequence mismatch" in reused[1],
          f"a reused sequence: {reused}")
    b0 = c_blobs[0]
    flipped_blob = blob_pkg.new_blob(b0.namespace(), bytes([b0.data[0] ^ 1]) + b0.data[1:], 0)
    flipped = chain_check(c_check, blob_pkg.marshal_blob_tx(c_txs[0].marshal(), [flipped_blob]))
    check(flipped[0] != 0 and "invalid share commitment" in flipped[1],
          f"a blob flipped after signing: {flipped}")
    doc0 = sign_doc_bytes(c_txs[0].body_bytes(), c_txs[0].auth_info_bytes(), CHAIN_ID, 0)
    bad_sig = bytearray(c_txs[0].signatures[0])
    bad_sig[17] ^= 0x04
    check(not crypto.verify_signature(c_pub, doc0, bytes(bad_sig)),
          "a signature with a flipped bit verifies")
    tx60, _raw60 = sign_chain_tx(c_key, c_msgs[1], c_blobs[1], 60)
    sig60 = bytearray(tx60.signatures[0])
    sig60[17] ^= 0x04
    tx60.signatures = [bytes(sig60)]
    bad_ante = chain_check(c_check, blob_pkg.marshal_blob_tx(tx60.marshal(), [c_blobs[1]]))
    check(bad_ante[0] != 0 and "signature verification failed" in bad_ante[1],
          f"a flipped signature through the ante: {bad_ante}")
    # BeginBlock, DeliverTx of the 60, Commit
    delivered, app_hash = chain_deliver(c_store, c_raws, c_times)
    check(all(code == 0 for code, _log in delivered),
          f"DeliverTx refused {[r for r in delivered if r[0]][:2]}")
    check(app_hash.hex() == CHAIN_APP_HASH,
          f"the app hash {app_hash.hex()} != the CPU-pinned {CHAIN_APP_HASH}")
    host_s = time.perf_counter() - t_phase
    # on the card: build the square, stage the blobs in a fresh arena,
    # assemble and root it with the counts from 0
    c_square, c_kept, c_builder = square_pkg.build_ex(c_raws, 1, PROPOSAL_K)
    ck = square_pkg.square_size(len(c_square))
    check(ck == PROPOSAL_K and len(c_kept) == len(c_raws),
          f"the signed block's square is k = {ck} with {len(c_kept)} of {len(c_raws)} txs")
    c_arena = DeviceBlobArena(device=dev)
    c_arena.put_many([b.data for _s, b in c_builder.blob_layout()])
    c_arena.ready()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    c_dah = proposal.assembled_proposal_dah(c_arena, c_square, c_builder, ck, dev)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    emit(phase="main_path", entry="assembled_proposal_dah", block="chain", k=ck,
         launches=counts)
    want = {"assemble_square": 1, "leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1}
    check(c_dah is not None and counts == {**dict.fromkeys(counts, 0), **want},
          f"assembled_proposal_dah on the signed block launched {counts}: {want} expected")
    c_arr = np.frombuffer(b"".join(to_bytes(c_square)), np.uint8).reshape(ck, ck, SHARE_SIZE)
    c_rows, c_cols = extend.roots_device(c_arr, dev)
    check(c_dah.row_roots == [r.tobytes() for r in c_rows]
          and c_dah.column_roots == [c.tobytes() for c in c_cols]
          and c_dah.hash() == host_dah(c_rows, c_cols),
          "the signed block's assembled DAH differs from roots_device's")
    check(c_dah.hash().hex() == CHAIN_DAH_HASH,
          f"the signed block's DAH {c_dah.hash().hex()} != the CPU-pinned {CHAIN_DAH_HASH}")
    med = statistics.median
    emit(phase="chain", txs=len(c_raws), accepted=len(c_raws) - len(refused),
         refusals={"reused_sequence": reused[1], "flipped_blob": flipped[1],
                   "flipped_signature": bad_ante[1]},
         sign_ms=med(sign_ms), commitment_ms=med(commitment_ms), verify_ms=med(verify_ms),
         validate_blob_tx_ms=med(c_times["validate_blob_tx"]),
         check_ante_ms=med(c_times["check_ante"]), deliver_ms=med(c_times["deliver"]),
         commit_ms=c_times["commit"][0], host_seconds=host_s,
         phase_seconds=time.perf_counter() - t_phase,
         app_hash=app_hash.hex(), dah=c_dah.hash().hex())

    phase_start("6f")
    # ---- phase 6f: the App. The same block through the port's App on the
    # card: proposer, replica, commit, ExtendBlock, the IBC and Blobstream
    # modules, and the degrade drill
    app_phase(dev, emit, c_key, c_raws, args.crossover_out)

    phase_start("6g")
    # ---- phase 6g: the node. Config 8b's traffic through the port's Node:
    # mempool, block production and application with retention and persist,
    # a restart that replays with one batched DA check, and state sync
    node_phase(dev, emit, c_key, c_raws, batched_launches[(PROPOSAL_K, 2)])

    phase_start("6h")
    # ---- phase 6h: the device lane. Bench squares through the block
    # pipeline (bare and through a node with a home) against the serial
    # entries, the ledger across a strict second stream, phase 6b's crowd
    # through the dispatcher, and the codec service against the host backend
    lane_phase(dev, emit, [bench_square(sk, seed) for seed in LANE_SEEDS], crowd0,
               {kk: bench_square(kk, 42) for kk in CODEC_KS},
               {kk: repair_masks(kk)[0][1] for kk in CODEC_KS})

    phase_start("6i")
    # ---- phase 6i: multi-GPU. The tree's row-block mode against its plain
    # version; the routed entries, Row C and the XOR spelling on meshes of
    # shards against the single-device route, with their ms, launches and
    # collective bytes; the fallback; the pipeline on a mesh; and the
    # multi-process runtime over NCCL (one rank) and gloo (two processes)
    launches["nmt_tree_rows"] = mesh_phase(
        dev, emit, same, [bench_square(sk, seed) for seed in MESH_SEEDS],
        [bench_square(sk, seed) for seed in LANE_SEEDS], tree_square, dev_bytes)

    phase_start("6j")
    # ---- phase 6j: the network surface. Config 8b's block through POST
    # /produce_block on a node behind its RpcServer (and applied by a replica
    # behind another), the fraud-aware light client against both and against a
    # proven bad encoding, 6b's crowd over HTTP, the prober, readiness, the
    # metrics, gRPC, and the CLI's start, query and light
    rpc_phase(dev, emit, c_key, c_raws, [bench_square(sk, seed) for seed in LANE_SEEDS[:4]],
              crowd0)

    phase_start("6k")
    # ---- phase 6k: harnesses and scenarios. A paged k = 128 crowd through
    # the gateway over three chaos nodes on the card, a restart of one from
    # its store, the scenario world's audited production under flips, and
    # the smoke scenario twice on one seed
    harness_phase(dev, emit)

    phase_start("7")
    # ---- phase 7: timing
    def bound(ops_s: float, nbytes: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(ops_s, t_bytes) * 1e3, ("operations" if ops_s >= t_bytes else "bytes")

    k = 128
    n = k * SHARE_SIZE
    nc = n // SHARE_SIZE
    x2 = torch.from_numpy(main_sq.reshape(k, n)).to(dev)
    m2 = rs.encode_matrix(k, dev)
    ops = xor_cuda.schedule_operands(k, dev)
    ns_pad = rs_cuda.pad_namespaces(torch.from_numpy(main_sq[..., :NAMESPACE_SIZE]).to(dev))
    # SHA blocks cost the counted ALU- and FMA-pipe operations each (phase 1)
    leaf_blocks = LEAF_BLOCKS * k * nc
    # the encode's three known spellings: the dense GF(2) product on the
    # int8 tensor cores (beside the hash on the integer pipes); the compiled
    # schedule's XORs bit-sliced 32 lanes to an int32 word, each output row
    # assembled with three-input XORs (LOP3): one operation per node and
    # ceil((nnz - 1) / 2) per row, on the ALU pipe with the hash; and
    # Leopard's additive FFT, 4 lanes to a word, its ALU work beside the
    # hash and its byte lookups on the shared-memory pipe
    dense_ops = 2 * (8 * k) ** 2 * n / INT8_OPS_PER_S
    nnz = (ops.sched.row_idx != ops.sched.zero).sum(axis=1)
    xor3_ops = ops.sched.n_nodes + int((nnz // 2).sum())
    xor_alu = xor3_ops * (n / 32)
    operand_bytes = ops.prog.numel() * ops.prog.element_size()
    # the XOR spelling's own floors: its operations on the ALU pipe, and its
    # operand reads from shared memory (every node's two and every row
    # operand, 16 bytes a 128 lanes, one 128-byte wavefront a clock and SM);
    # beside them the floor of this layout's reads (each group's nodes, and
    # the zero-plane padding)
    smem_words_per_s = SMEM_WAVEFRONT_WORDS * SMS * CLOCK_HZ
    xor_smem_floor = (2 * ops.sched.n_nodes + int(nnz.sum())) * (n / 32) / smem_words_per_s
    xor_layout_floor = ops.layout.padded_reads * (n / 32) / smem_words_per_s
    fft_mul, fft_plain = fft_butterflies(m2.fft_group.cpu().numpy() >= 0)
    fft_alu = (fft_mul * FFT_MUL_OPS + fft_plain * FFT_PLAIN_OPS) * (n / 4)
    fft_lookups = fft_mul * n / LOOKUPS_PER_S
    fft_bytes = m2.fft_rows.numel() + 2 * m2.fft_group.numel()
    digest_bytes = k * nc * 32

    def encode_bound(hashed: bool) -> tuple[float, str]:
        """The bound of the encode's function (FFT and XOR kernels alike):
        the cheapest of its three spellings."""
        alu, fma, out = ((leaf_blocks * sha_alu, leaf_blocks * sha_fma, digest_bytes)
                         if hashed else (0, 0, 0))
        return min(bound(max(dense_ops, pipe_seconds(alu, fma)),
                         2 * k * n + (8 * k) ** 2 // 8 + out),
                   bound(pipe_seconds(xor_alu + alu, fma), 2 * k * n + operand_bytes + out),
                   bound(max(pipe_seconds(fft_alu + alu, fma), fft_lookups),
                         2 * k * n + fft_bytes + out))

    def leaf_bound(rows: int) -> tuple[float, str]:
        """K2's bound on (rows, rows·512): its SHA blocks, and each cell,
        namespace and digest moved once."""
        blocks = LEAF_BLOCKS * rows * rows
        return bound(pipe_seconds(blocks * sha_alu, blocks * sha_fma),
                     rows * rows * (SHARE_SIZE + 2 * 32))

    bounds = {
        "encode2d_hash": encode_bound(True),
        "leaf_digests2d": leaf_bound(k),
        "encode2d": encode_bound(False),
        "encode2d_xor_hash": encode_bound(True),
        "encode2d_xor": encode_bound(False),
    }
    xor_floors = {"xor_alu_floor_ms": pipe_seconds(xor_alu, 0) * 1e3,
                  "xor_smem_floor_ms": xor_smem_floor * 1e3,
                  "xor_layout_floor_ms": xor_layout_floor * 1e3}
    emit(phase="bounds", k=k, dense_int8_ms=dense_ops * 1e3, xor3_ops_per_word=xor3_ops,
         **xor_floors, fft_mul_butterflies=fft_mul,
         fft_plain_butterflies=fft_plain, fft_int32_ms=pipe_seconds(fft_alu, 0) * 1e3,
         fft_lookup_ms=fft_lookups * 1e3, sha_block_alu_ops=sha_alu, sha_block_fma_ops=sha_fma,
         sha_ms=pipe_seconds(leaf_blocks * sha_alu, leaf_blocks * sha_fma) * 1e3,
         encode_bound_ms=bounds["encode2d"][0], encode_hash_bound_ms=bounds["encode2d_hash"][0])
    eds_dev = main_eds.device_data
    ns_eds = rs_cuda.pad_namespaces(extend._leaf_namespaces(
        eds_dev[:k, :k, :NAMESPACE_SIZE], k).contiguous())
    x_eds = eds_dev.reshape(2 * k, 2 * n)
    # K2 at the governance-default square, k = 64: its Q0 and its EDS
    sq64 = squares[0][2]
    x64 = torch.from_numpy(sq64.reshape(64, 64 * SHARE_SIZE)).to(dev)
    ns64 = rs_cuda.pad_namespaces(torch.from_numpy(sq64[..., :NAMESPACE_SIZE]).to(dev))
    eds64 = da.extend_shares(sq64.reshape(-1, SHARE_SIZE), dev).device_data
    ns_eds64 = rs_cuda.pad_namespaces(extend._leaf_namespaces(
        eds64[:64, :64, :NAMESPACE_SIZE], 64).contiguous())
    x_eds64 = eds64.reshape(128, 128 * SHARE_SIZE)
    # (call, k, rows) of K2's four timed shapes
    leaf_shapes = (("leaf_digests2d", k, k), ("leaf_digests2d_eds", k, 2 * k),
                   ("leaf_digests2d_64", 64, 64), ("leaf_digests2d_eds_64", 64, 128))
    calls = {
        "encode2d_hash": lambda: rs_cuda.encode2d_hash(x2, m2),
        "leaf_digests2d": lambda: rs_cuda.leaf_digests2d(x2, ns_pad),
        "leaf_digests2d_eds": lambda: rs_cuda.leaf_digests2d(x_eds, ns_eds),
        "leaf_digests2d_64": lambda: rs_cuda.leaf_digests2d(x64, ns64),
        "leaf_digests2d_eds_64": lambda: rs_cuda.leaf_digests2d(x_eds64, ns_eds64),
        "encode2d": lambda: rs_cuda.encode2d(x2, m2),
        "encode2d_xor_hash": lambda: xor_cuda.encode2d_xor_hash(x2, ops),
        "encode2d_xor": lambda: xor_cuda.encode2d_xor(x2, ops),
    }
    # K3 at the shapes of one device DAH (extend_and_root_device): the 4k
    # axis roots' merkle leaves, then its 2k, k, ..., 1 nodes, 2 blocks each
    k3_shapes = []
    for batch in dah_levels(k):
        words = dev_bytes((16 * DAH_BLOCKS, batch * 4)).view(torch.int32)
        words = words.view(torch.uint32).reshape(16 * DAH_BLOCKS, batch)
        k3_shapes.append((batch, words))
        calls[f"sha256_words_{batch}"] = (lambda w=words: sha256_cuda.sha256_words(w))
    # K3's merkle form on the device DAH's roots at k = 64 and 128, as
    # extend_and_root hands them over (the tree kernel's (2, 2k, 90) roots)
    dah_roots = {}
    for kk, sq in ((64, squares[0][2]), (k, main_sq)):
        _e, r_kk = extend._roots(torch.from_numpy(sq).to(dev), rs.encode_matrix(kk, dev))
        dah_roots[kk] = r_kk.reshape(1, 4 * kk, merkle_cuda.ROOT_SIZE)
        calls[f"dah_merkle_{kk}"] = lambda r=dah_roots[kk]: merkle_cuda.dah_merkle(r)

    # the tree kernel at its two main-path calls, k = 64 and 128: an
    # extend's (both families, K1's and K2's digest tiles in the fused
    # route's layout) and eds_row_levels_device's (rows and their levels,
    # four slices of K2's grid over the EDS)
    tree_calls = {}
    for kk, sq in ((64, squares[0][2]), (k, main_sq)):
        grid = dev_bytes((2 * kk, 2 * kk, 32)).view(torch.int32).view(torch.uint32)
        d1t = grid[:kk, kk:].transpose(0, 1).contiguous()
        d3t = grid[kk:, kk:].transpose(0, 1).contiguous()
        fused = (grid[:kk, :kk].contiguous(), d1t.transpose(0, 1),
                 grid[kk:, :kk].contiguous(), d3t.transpose(0, 1))
        sliced = (grid[:kk, :kk], grid[:kk, kk:], grid[kk:, :kk], grid[kk:, kk:])
        q0_ns = torch.from_numpy(sq).to(dev)[..., :NAMESPACE_SIZE]
        tree_calls[f"nmt_tree_both_{kk}"] = (kk, 2, (fused, q0_ns), {})
        tree_calls[f"nmt_tree_levels_{kk}"] = (kk, 1, (sliced, q0_ns), {"keep_levels": True})
    for name, (_kk, _f, a, kw) in tree_calls.items():
        calls[name] = (lambda a=a, kw=kw: nmt_cuda.nmt_tree(*a, **kw))
    # the row-block mode at k = 128 as Row C on the pipeline's (1, 2) mesh
    # calls it: a shard's block (its k/2 top and k/2 bottom rows, with their
    # levels) and the gathered grid's transpose (the column roots)
    rows_grid = dev_bytes((2 * k, 2 * k, 32)).view(torch.int32).view(torch.uint32)
    rows_ns = torch.from_numpy(main_sq).to(dev)[..., :NAMESPACE_SIZE]
    rp = k // MESH_MAIN[1]
    rows_calls = {
        f"nmt_tree_rows_shard_{k}": (k, rp, rp, ((
            rows_grid[:rp, :k], rows_grid[:rp, k:], rows_grid[k:k + rp, :k],
            rows_grid[k:k + rp, k:]), rows_ns[:rp]), {"keep_levels": True}),
        f"nmt_tree_rows_cols_{k}": (k, k, k, ((
            rows_grid[:k, :k].transpose(0, 1), rows_grid[k:, :k].transpose(0, 1),
            rows_grid[:k, k:].transpose(0, 1), rows_grid[k:, k:].transpose(0, 1)),
            rows_ns.transpose(0, 1)), {}),
    }
    for name, (_kk, _t, _b, a, kw) in rows_calls.items():
        calls[name] = (lambda a=a, kw=kw: nmt_cuda.nmt_tree_rows(*a, **kw))
    # the layout's levers on K6 at k = 128: the conflict-free order undone
    # for the rows, for the nodes, and the rows split over 8 groups, not 4
    levers = {"xor_lever_rows_shuffled": (ops.layout, (True, False)),
              "xor_lever_nodes_shuffled": (ops.layout, (False, True)),
              "xor_lever_groups_8": (xor_cuda.build_layout(ops.sched, 8, 2), (False, False))}
    for name, (lay, (rows, nodes)) in levers.items():
        prog = shuffled_layout_prog(lay, SEED, rows, nodes) if rows or nodes else lay.prog
        lever_ops = xor_cuda.XorOperands(sched=ops.sched, layout=lay,
                                         prog=torch.as_tensor(prog.view(np.int32), device=dev))
        check(torch.equal(xor_cuda.encode2d_xor(x2, lever_ops), xor_cuda.encode2d_xor(x2, ops)),
              f"{name}: the parity changed")
        calls[name] = lambda o=lever_ops: xor_cuda.encode2d_xor(x2, o)
    # the routing table's rungs: the fused routes' two encode kernels
    for kk in TABLE_K:
        xk = dev_bytes((kk, kk * SHARE_SIZE))
        m2k, opsk = rs.encode_matrix(kk, dev), xor_cuda.schedule_operands(kk, dev)
        calls[f"table_dense_{kk}"] = lambda x=xk, m=m2k: rs_cuda.encode2d_hash(x, m)
        calls[f"table_xor_{kk}"] = lambda x=xk, o=opsk: xor_cuda.encode2d_xor_hash(x, o)
        if kk == 64:  # K4 and K6 at the governance-default square, beside the rungs
            calls["encode2d_64"] = lambda x=xk, m=m2k: rs_cuda.encode2d(x, m)
            calls["encode2d_xor_64"] = lambda x=xk, o=opsk: xor_cuda.encode2d_xor(x, o)
    # the decode sweep at k = 128 and 64: a random mask's row sweep on its
    # repaired square (a sweep rewrites the same bytes, so every launch does
    # the same work)
    for kk, (swept, _plain_sq, plan, _p) in repair_timed.items():
        calls[f"decode_sweep_{kk}"] = lambda s=swept, p=plan: repair_cuda.sweep(s, p)
    # the ragged gather at the full-width crowd's one bucket (phase 6b)
    calls["ragged_gather"] = lambda: ragged_cuda.ragged_gather(*g_case)
    # the assembly at config 8b's square (phase 6c)
    calls["assemble_square"] = lambda: assemble_cuda.assemble_square(*asm_args)
    event_ms = {name: cuda_ms(fn, inner=10) for name, fn in calls.items()}
    plain_ms = {
        "encode2d_hash": cuda_ms(lambda: rs_cuda.encode2d_hash_reference(x2, m2)),
        "leaf_digests2d": cuda_ms(lambda: rs_cuda.leaf_digests2d_reference(x2, ns_pad)),
        "leaf_digests2d_eds": cuda_ms(
            lambda: rs_cuda.leaf_digests2d_reference(x_eds, ns_eds), reps=3),
        "leaf_digests2d_64": cuda_ms(lambda: rs_cuda.leaf_digests2d_reference(x64, ns64)),
        "leaf_digests2d_eds_64": cuda_ms(
            lambda: rs_cuda.leaf_digests2d_reference(x_eds64, ns_eds64)),
        "encode2d": cuda_ms(lambda: rs_cuda.encode2d_reference(x2, m2)),
        "encode2d_xor_hash": cuda_ms(lambda: xor_cuda.encode2d_xor_hash_reference(x2, ops)),
        "encode2d_xor": cuda_ms(lambda: xor_cuda.encode2d_xor_reference(x2, ops)),
    }
    plain_ms["ragged_gather"] = cuda_ms(lambda: ragged_cuda.gather_rows_reference(*g_case),
                                        reps=3)
    plain_ms["assemble_square"] = cuda_ms(lambda: assemble.assemble_square_reference(*asm_args),
                                          reps=3)
    # the one PyTorch call that computes the gather: torch.cat of the bucket's
    # row views (timed here as the kernels are, by the profiler and by CUDA
    # events; the port never calls it)
    row_views = [g_case[0][sl][r:r + 1] for sl, r in zip(g_case[1], g_case[2])]
    check(torch.equal(torch.cat(row_views), ragged_cuda.ragged_gather(*g_case)),
          "torch.cat of the row views differs from the ragged gather")
    library_calls = {"ragged_gather": lambda: torch.cat(row_views)}
    # the assembly's copy floor: one device-to-device copy_ of as many bytes
    # as the square (the same bytes moved, not the same function)
    copy_src = torch.empty(pk * pk * SHARE_SIZE, dtype=torch.uint8, device=dev)
    copy_dst = torch.empty_like(copy_src)
    library_calls["assemble_copy_floor"] = lambda: copy_dst.copy_(copy_src)
    library_event_ms = {name: cuda_ms(fn, inner=10) for name, fn in library_calls.items()}
    for kk, (_swept, plain_sq, plan, _p) in repair_timed.items():
        plain_ms[f"decode_sweep_{kk}"] = cuda_ms(
            lambda s=plain_sq, p=plan: repair_cuda.sweep_reference(s, p), reps=3)
    for batch, words in k3_shapes:
        plain_ms[f"sha256_words_{batch}"] = cuda_ms(
            lambda w=words: sha256_cuda.sha_core_reference(w))
    for kk, r in dah_roots.items():
        plain_ms[f"dah_merkle_{kk}"] = cuda_ms(lambda r=r: merkle_cuda.dah_merkle_reference(r),
                                               reps=3)
    for name, (_kk, _f, a, kw) in tree_calls.items():
        plain_ms[name] = cuda_ms(lambda a=a, kw=kw: nmt_cuda.nmt_tree_reference(*a, **kw),
                                 reps=3)
    for name, (_kk, _t, _b, a, kw) in rows_calls.items():
        plain_ms[name] = cuda_ms(lambda a=a, kw=kw: nmt_cuda.nmt_tree_rows_reference(*a, **kw),
                                 reps=3)

    # end to end, the routes in turns (sample i of every route back to back,
    # so the host's noise falls on all of them alike)
    squares_e2e = {64: realistic(64, 0), 128: main_sq}
    e2e: dict[tuple, list[float]] = {}
    for kk, sq in squares_e2e.items():
        entries = {"roots_device": lambda: extend.roots_device(sq, dev),
                   "extend_roots_device_resident":
                       lambda: extend.extend_roots_device_resident(sq, dev)}
        for rep in range(2 + E2E_REPS):  # two warm-up rounds
            for rname in ROUTES:
                with pinned(rname):
                    for entry, fn in entries.items():
                        t = time.perf_counter()
                        fn()  # ends in a D2H copy of the roots, so the device is done
                        ms = (time.perf_counter() - t) * 1e3
                        if rep >= 2:
                            e2e.setdefault((kk, rname, entry), []).append(ms)
        for rname in ROUTES:
            for entry in entries:
                xs = e2e[(kk, rname, entry)]
                q1, _q2, q3 = statistics.quantiles(xs, n=4)
                emit(phase="end_to_end", k=kk, route=rname, entry=entry,
                     ms=statistics.median(xs), min_ms=min(xs), q1_ms=q1, q3_ms=q3,
                     samples=len(xs))
        eds_kk = extend.extend_roots_device_resident(sq, dev)[0]
        emit(phase="end_to_end", k=kk, route=None, entry="eds_row_levels_device",
             ms=host_ms(lambda: extend.eds_row_levels_device(eds_kk, dev)))
    with pinned("fused-dense"):  # the device DAH's entry
        dah_entry_ms = {kk: host_ms(lambda sq=sq: extend.extend_and_root_device(sq, dev))
                        for kk, sq in squares_e2e.items()}
    profiled_entries = {"roots_device": extend.roots_device,
                        "extend_roots_device_resident": extend.extend_roots_device_resident}

    # ONE profiler session (separate sessions in one process lost their
    # records on the card): a warm-up pass (the profiler can miss the first
    # records of a session), then REPS launches of each timed kernel, then
    # one k = 128 roots_device call per route; every call apart from the
    # next by a 100 ms host sleep. The device records, split at those idle
    # gaps, are one segment per call: a timed call's segment holds only its
    # kernel (one name), and its device time per launch is the mean over
    # the records there; a route's segment is its roots_device breakdown.
    # The idle share is taken against the unprofiled median above and
    # against the profiled call's own host time: the profiler slows the
    # host, and the pageable H2D copy of the square varies from call to
    # call, so the first can read below 0 when that copy dominates.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gap_s = 0.1
    for rname in ROUTES:
        with pinned(rname):
            extend.roots_device(main_sq, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        for fn in calls.values():
            time.sleep(gap_s)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        profiled_ms = {}
        for rname in ROUTES:
            for entry, fn in profiled_entries.items():
                time.sleep(gap_s)
                with pinned(rname):
                    t = time.perf_counter()
                    fn(main_sq, dev)  # ends in a D2H copy of the roots
                    profiled_ms[(rname, entry)] = (time.perf_counter() - t) * 1e3
                torch.cuda.synchronize()
        # the device DAH of extend_and_root, alone: the k = 128 roots on the
        # card to the DAH hash
        time.sleep(gap_s)
        extend.merkle_root_pow2(dah_roots[k][0])
        torch.cuda.synchronize()
        for fn in library_calls.values():  # last: the segments above keep their places
            time.sleep(gap_s)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"), key=lambda e: e.time_range.start)
    segments: list[list] = []
    last_end = None
    for e in evs:
        if last_end is None or e.time_range.start - last_end > gap_s * 1e6 / 2:  # µs
            segments.append([])
        segments[-1].append(e)
        last_end = e.time_range.end if last_end is None else max(last_end, e.time_range.end)
    n_calls = len(calls) + len(profiled_ms) + 1 + len(library_calls)
    check(len(segments) in (n_calls, n_calls + 1),  # + 1: the warm-up pass
          f"the profiler's records split into {len(segments)} calls, expected {n_calls}")
    segments = segments[-n_calls:]
    # a library call's device time: every record of its segment (it may
    # launch several kernels), per call
    library_ms = {}
    for name, seg in zip(library_calls, segments[n_calls - len(library_calls):]):
        check(len(seg) > 0 and not any("celestia::" in e.name for e in seg),
              f"the profiler's records of torch's {name} hold {sorted({e.name for e in seg})}")
        library_ms[name] = sum(e.time_range.elapsed_us() for e in seg) / 1e3 / REPS
    dev_ms, per_launch = {}, {}
    for name, seg in zip(calls, segments):
        kern = [e for e in seg if "celestia::" in e.name]
        check(len(kern) > 0 and len({e.name for e in kern}) == 1,
              f"the profiler's records of {name} hold {sorted({e.name for e in seg})}")
        per_launch[name] = [e.time_range.elapsed_us() / 1e3 for e in kern]
        dev_ms[name] = statistics.fmean(per_launch[name])
    emit(phase="profile_records", launches_per_call=REPS,
         records={name: len(v) for name, v in per_launch.items()})

    # the port's dense/XOR routing table, by device time. The fused routes
    # differ only in their encode kernel (K1 or K5, 3 launches per extend),
    # so a rung's time per spelling is 3 x that kernel's mean device time
    # per launch. A rung enters the table only where the two spellings'
    # launches do not overlap (the faster's slowest below the slower's
    # fastest); the lookup takes the nearest rung for the others.
    committed = calibration.load_xor_table()
    table, rungs = calibration.xor_table_from_launches(
        {kk: {"dense": per_launch[f"table_dense_{kk}"], "xor": per_launch[f"table_xor_{kk}"]}
         for kk in TABLE_K}, time.time(), card_name, power_limit)
    for kk, rung in rungs.items():
        rung["committed_winner"] = committed.winner(kk) if committed else None
    emit(phase="xor_table", basis="device ms of one extend's 3 fused encode launches",
         rungs=rungs, table=table.to_json(),
         agrees_with_committed=all(
             (committed.winner(kk) if committed else "dense") == table.winner(kk)
             for kk in table.entries))
    # beside it, the operator's check of the same table: the same launches
    # timed by CUDA events under the same rule, at the JAX package's rungs
    crossover_xor = calibration.measure_xor_crossover(device=dev)
    emit(phase="lane", part="xor_crossover", basis="CUDA-event device ms of one extend's 3 "
         "fused encode launches, resolved rungs only", ks=list(calibration.XOR_DEFAULT_KS),
         table=crossover_xor.to_json()["entries"],
         agrees_with_xor_table={kk: crossover_xor.winner(kk) == table.winner(kk)
                                for kk in crossover_xor.entries if kk in table.entries})
    if args.xor_table_out:
        with open(args.xor_table_out, "w") as f:
            json.dump(table.to_json(), f, indent=2)
            f.write("\n")
    segments = segments[len(calls):]
    dah_seg = segments[len(profiled_ms)]
    dah_aten = sorted({e.name[:90] for e in dah_seg if "celestia::" not in e.name
                       and not e.name.startswith(("Memcpy", "Memset"))})
    dah_h2d = sum("HtoD" in e.name for e in dah_seg)
    check([e.name for e in dah_seg if "celestia::" in e.name] != [] and not dah_aten
          and dah_h2d == 0, f"the device DAH ran {sorted(e.name[:90] for e in dah_seg)}: "
                            f"one merkle launch, no aten op and no H2D copy expected")
    emit(phase="main_path", route="fused-dense", k=main_sq.shape[0],
         entry="extend_and_root_device", launches=dah_counts, dah=dah_dev.tobytes().hex(),
         dah_launches=len(dah_seg), dah_aten_ops=len(dah_aten), dah_h2d_copies=dah_h2d,
         wall_ms=dah_entry_ms)
    for (rname, entry), seg in zip(profiled_ms, segments):
        by_op: dict[str, list] = {}
        for e in seg:
            cell = by_op.setdefault(e.name[:90], [0.0, 0])
            cell[0] += e.time_range.elapsed_us() / 1e3
            cell[1] += 1
        busy_ms = sum(v[0] for v in by_op.values())
        check(busy_ms > 0, f"the profiler recorded no device time for {entry} on {rname}")
        top = sorted(by_op.items(), key=lambda kv: -kv[1][0])
        # aten ops: launches neither of the port's kernels nor copies
        aten = {name: v for name, v in by_op.items()
                if "celestia::" not in name and not name.startswith(("Memcpy", "Memset"))}
        aten_launches = sum(v[1] for v in aten.values())
        median_ms = statistics.median(e2e[(128, rname, entry)])
        emit(phase="profile", k=main_sq.shape[0], route=rname, entry=entry,
             device_busy_ms=busy_ms, median_ms=median_ms,
             device_idle_share=1 - busy_ms / median_ms,
             profiled_call_ms=profiled_ms[(rname, entry)],
             profiled_idle_share=1 - busy_ms / profiled_ms[(rname, entry)],
             device_ops=len(by_op), launches=sum(v[1] for v in by_op.values()),
             aten_launches=aten_launches, aten_ms=sum(v[0] for v in aten.values()),
             aten_ops=sorted(aten),
             h2d_copies=sum(v[1] for name, v in by_op.items() if "HtoD" in name),
             h2d_ms=sum(v[0] for name, v in by_op.items() if "HtoD" in name),
             top=[{"op": name, "ms": v[0], "count": v[1]} for name, v in top[:12]])
        if rname == "fused-dense":
            # no EDS assembled by roots_device; at most Q0's one copy into the
            # EDS beside the kernels on the resident path
            limit = 0 if entry == "roots_device" else 1
            check(aten_launches <= limit, f"{entry} on {rname} launched {aten_launches} aten "
                                          f"ops ({sorted(aten)}), at most {limit} expected")

    results = {}
    for kname, b in bounds.items():
        results[kname] = (dev_ms[kname], event_ms[kname], plain_ms[kname], b)
    k3_dev = k3_event = k3_plain = k3_bytes = 0.0
    for batch, _words in k3_shapes:
        name = f"sha256_words_{batch}"
        emit(phase="timing", kernel="sha256_words", shape=[16 * DAH_BLOCKS, batch],
             device_ms=dev_ms[name], event_ms=event_ms[name], plain_ms=plain_ms[name])
        k3_dev += dev_ms[name]
        k3_event += event_ms[name]
        k3_plain += plain_ms[name]
        k3_bytes += 16 * DAH_BLOCKS * batch * 4 + 8 * batch * 4
    # one merkle tree of len(k3_shapes) levels (leaves, then nodes): the
    # larger of all its blocks at the card's rate and its chain of levels
    # (the design's one launch a level, level_floor_ms, is not the bound)
    k3_batches = [batch for batch, _w in k3_shapes]
    k3_throughput = pipe_seconds(sum(k3_batches) * DAH_BLOCKS * sha_alu,
                                 sum(k3_batches) * DAH_BLOCKS * sha_fma)
    k3_chain = tree_chain_seconds(len(k3_batches), DAH_BLOCKS, round_alu, round_fma)
    emit(phase="timing", kernel="sha256_words", k=k, shapes="one device DAH",
         launches=len(k3_shapes), device_ms=k3_dev, event_ms=k3_event, plain_ms=k3_plain,
         bound_ms=k3_throughput * 1e3, chain_floor_ms=k3_chain * 1e3,
         level_floor_ms=chain_floor_seconds(k3_batches, DAH_BLOCKS, sha_alu, sha_fma) * 1e3)
    results["sha256_words"] = (k3_dev, k3_event, k3_plain,
                               bound(max(k3_throughput, k3_chain), k3_bytes))
    # K3's merkle form: the same tree, its bound the same two terms; the
    # bytes are the roots in and the hash out
    for kk in dah_roots:
        name = f"dah_merkle_{kk}"
        levels = dah_levels(kk)
        throughput = pipe_seconds(sum(levels) * DAH_BLOCKS * sha_alu,
                                  sum(levels) * DAH_BLOCKS * sha_fma)
        chain = tree_chain_seconds(len(levels), DAH_BLOCKS, round_alu, round_fma)
        b_ms, b_by = bound(max(throughput, chain), 4 * kk * merkle_cuda.ROOT_SIZE + 32)
        emit(phase="timing", kernel="dah_merkle", k=kk, device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name], bound_ms=b_ms, bound_by=b_by,
             throughput_ms=throughput * 1e3, chain_floor_ms=chain * 1e3,
             cluster=merkle_cuda.cluster_size(4 * kk),
             k3_launches=len(levels) if kk == k else None,
             k3_device_ms=k3_dev if kk == k else None)
        if kk == k:
            results["dah_merkle"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))
    for name, (kk, fams, _a, kw) in tree_calls.items():
        throughput, chain = nmt_tree_floor(kk, fams, sha_alu, sha_fma, round_alu, round_fma)
        level_floor = chain_floor_seconds(nmt_tree_levels(kk, fams), NODE_BLOCKS,
                                          sha_alu, sha_fma)
        w = 2 * kk
        nbytes = w * w * 32 + kk * kk * NAMESPACE_SIZE + fams * w * 90
        if kw.get("keep_levels"):
            nbytes += w * (2 * w - 1) * 90
        b_ms, b_by = bound(max(throughput, chain), nbytes)
        emit(phase="timing", kernel="nmt_tree", k=kk, call=name, families=fams,
             keep_levels=bool(kw.get("keep_levels")), device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name],
             bound_ms=throughput * 1e3, chain_floor_ms=chain * 1e3,
             level_floor_ms=level_floor * 1e3, row_bound_ms=b_ms, bound_by=b_by)
        if name == f"nmt_tree_both_{k}":
            results["nmt_tree"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))
    # the row-block mode: its rows' inner nodes (families = rows / 2k) and
    # one tree's chain; the digests read, the top rows' namespaces, the roots
    # and the levels written
    for name, (kk, top, bottom, _a, kw) in rows_calls.items():
        rows = top + bottom
        throughput, chain = nmt_tree_floor(kk, rows / (2 * kk), sha_alu, sha_fma, round_alu,
                                           round_fma)
        w = 2 * kk
        nbytes = rows * w * 32 + top * kk * NAMESPACE_SIZE + rows * 90
        if kw.get("keep_levels"):
            nbytes += rows * (2 * w - 1) * 90
        b_ms, b_by = bound(max(throughput, chain), nbytes)
        emit(phase="timing", kernel="nmt_tree_rows", k=kk, call=name, top_rows=top,
             bottom_rows=bottom, keep_levels=bool(kw.get("keep_levels")), device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name], bound_ms=throughput * 1e3,
             chain_floor_ms=chain * 1e3, row_bound_ms=b_ms, bound_by=b_by)
        if name == f"nmt_tree_rows_shard_{k}":
            results["nmt_tree_rows"] = (dev_ms[name], event_ms[name], plain_ms[name],
                                        (b_ms, b_by))
    for kname, (t_d, t_e, t_p, (b_ms, b_by)) in results.items():
        if kname not in ("leaf_digests2d", "nmt_tree", "nmt_tree_rows", "sha256_words",
                         "dah_merkle"):
            floors = xor_floors if kname.startswith("encode2d_xor") else {}
            emit(phase="timing", kernel=kname, k=k, device_ms=t_d, event_ms=t_e, plain_ms=t_p,
                 bound_ms=b_ms, bound_by=b_by, **floors)
    for call, kk, rows in leaf_shapes:
        b_ms, b_by = leaf_bound(rows)
        emit(phase="timing", kernel="leaf_digests2d", k=kk, shape=[rows, rows * SHARE_SIZE],
             device_ms=dev_ms[call], launch_range_ms=[min(per_launch[call]), max(per_launch[call])],
             event_ms=event_ms[call], plain_ms=plain_ms[call], bound_ms=b_ms, bound_by=b_by)
    emit(phase="xor_levers", k=k, kernel="encode2d_xor", default_ms=dev_ms["encode2d_xor"],
         **{name[len("xor_lever_"):] + "_ms": dev_ms[name] for name in levers},
         groups_8_padding=levers["xor_lever_groups_8"][0].padded_reads
         / levers["xor_lever_groups_8"][0].reads - 1)
    for kname, call in (("encode2d_hash", "table_dense_64"), ("encode2d", "encode2d_64"),
                        ("encode2d_xor", "encode2d_xor_64")):
        emit(phase="timing", kernel=kname, k=64, device_ms=dev_ms[call],
             event_ms=event_ms[call])

    for kk, (_s, _q, _plan, plan_np) in repair_timed.items():
        name = f"decode_sweep_{kk}"
        work = decode_sweep_work(rs.decode_program(2 * kk), plan_np.scale_bytes,
                                 plan_np.write)
        alu_s = pipe_seconds(work["alu_ops"], 0)
        lookup_s = work["lookups"] / LOOKUPS_PER_S
        b_ms, b_by = bound(max(alu_s, lookup_s), work["bytes"])
        emit(phase="timing", kernel="decode_sweep", k=kk, sweep="row", **work,
             device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name], alu_ms=alu_s * 1e3,
             lookup_ms=lookup_s * 1e3, bytes_ms=work["bytes"] / HBM_BYTES_PER_S * 1e3,
             bound_ms=b_ms, bound_by=b_by)
        if kk == 128:
            results["decode_sweep"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))

    # the ragged gather: every row read once and written once
    g_rows, g_row_bytes = len(g_case[1]), int(np.prod(g_case[0][0].shape[1:]))
    g_bound = bound(0.0, 2 * g_rows * g_row_bytes)
    emit(phase="timing", kernel="ragged_gather", k=SERVING_K, rows=g_rows,
         pages=len(g_case[0]), row_bytes=g_row_bytes, device_ms=dev_ms["ragged_gather"],
         launch_range_ms=[min(per_launch["ragged_gather"]), max(per_launch["ragged_gather"])],
         event_ms=event_ms["ragged_gather"], plain_ms=plain_ms["ragged_gather"],
         bound_ms=g_bound[0], bound_by=g_bound[1])
    results["ragged_gather"] = (dev_ms["ragged_gather"], event_ms["ragged_gather"],
                                plain_ms["ragged_gather"], g_bound)
    emit(phase="library", kernel="ragged_gather", call="torch.cat of the row views",
         device_ms=library_ms["ragged_gather"], event_ms=library_event_ms["ragged_gather"],
         kernel_device_ms=dev_ms["ragged_gather"], kernel_event_ms=event_ms["ragged_gather"])

    # the assembly: every cell written once, every blob byte and host row read once
    a_bound = bound(0.0, asm_bytes)
    emit(phase="timing", kernel="assemble_square", k=pk, blobs=len(blobs),
         host_table_rows=len(p_inputs["host_shares"]), bytes=asm_bytes,
         device_ms=dev_ms["assemble_square"],
         launch_range_ms=[min(per_launch["assemble_square"]),
                          max(per_launch["assemble_square"])],
         event_ms=event_ms["assemble_square"], plain_ms=plain_ms["assemble_square"],
         bound_ms=a_bound[0], bound_by=a_bound[1],
         copy_floor_ms=library_ms["assemble_copy_floor"],
         copy_floor_event_ms=library_event_ms["assemble_copy_floor"])
    results["assemble_square"] = (dev_ms["assemble_square"], event_ms["assemble_square"],
                                  plain_ms["assemble_square"], a_bound)

    check(set(results) == set(KERNEL_SOURCES) == set(_cuda.LAUNCHES),
          f"the kernels line has {sorted(results)}, the port {sorted(_cuda.LAUNCHES)}")
    kernels = []
    for kname, (t_d, _t_e, t_p, (b_ms, b_by)) in results.items():
        src, replaces = KERNEL_SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": t_d, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms.get(kname),
        })
    phase_start("end")
    emit(phase="phase_seconds", seconds={
        name: t1 - t0 for (name, t0), (_next, t1) in zip(phase_marks, phase_marks[1:])},
        total=phase_marks[-1][1] - phase_marks[0][1])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
