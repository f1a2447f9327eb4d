#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure (exit code 1, and the final `ok` line is
not printed):

  1. build   - nvcc builds every kernel of the port from native/csrc/ (one
               process per source, all at once); prints the card's name
               and power limit as nvidia-smi reports them.
  2. kernels - each kernel against its plain-torch version on the card, at
               the shapes of the main paths (config 4's 100k x 40, the
               service's 670k x 40 and the 1M x 40 run) and at ragged
               shapes with -1 pads: vmem_gather
               bitwise at 999x37 (a stream not a multiple of 4), 3x999x37
               and 3x31x7 with a per-row and a shared t (batch rows that
               start mid-vector, straddle tiles, or are shorter than one),
               1x1, 0 rows, 100k x 40, 670k x 40 and 1M x 40 plain,
               batched and shared-t; score_update in both forms (three
               outputs, and decay-only with_score=False) against its
               plain version, the decayed counters bitwise and the score
               within rtol 1e-5 / atol 1e-6, at 1000x37, 999x37 (numel
               not a multiple of 4), 0 rows, x[1:] views of (1001, 37)
               tensors (4 bytes off a 16-byte boundary: the scalar
               loop; and fmd against slow at another offset), 100k x 40,
               670k x 40 and 1M x 40.
               Times each L2-cold (the cache flushed before every call,
               CUDA events around each call) at the three main-path
               shapes beside its plain version, a library yardstick and
               its bound, score_update in both forms (its time before
               the Hopper redesign printed beside them); for vmem_gather at 1M x 40
               also the same call on src sorted ascending (sequential reads of t) and one whole
               relaxation sweep (exchange._inc_from plus the row min) on
               synthetic RecvConstants.
  3. parity  - the Simulator at 2048 peers on CUDA and on the CPU, with the
               pull budget lowered so the receiver-side path (and so the
               gather kernel) runs: latencies, shadowlog and summaries must
               be byte-identical.
  3b. exact  - exact delivery mode (the model of record):
               (a) CUDA vs CPU at 2048 peers, 3 messages, in a gossip-heavy
               setting that triggers the refinement (no flood publish,
               D_lazy 12), through three routes: the prefix engine (default
               budget), the serial engine (answer_queue_mode "serial") and
               the serial engine receiver-side (budget lowered: the gather
               kernel). Outputs byte-identical, the route's engine counter
               > 0 and equal on both devices, the gather launched on the
               lowered route.
               (b) BASELINE config 4 at full width through the `run` entry
               with the default (exact) delivery mode: 100,000 peers, 4
               fragments of 15 KB, churn 0.001, a 60 s warm-up, 3 messages
               2 s apart. Counts zeroed just before and read just after;
               fails on an unconverged fixpoint or a kernel of the path
               that never launched.
               (c) one config-4 exact publish run three times from one
               state (warm, timed, under torch.profiler; same delays):
               fast-pipeline and refinement time (the disseminate spans),
               host syncs, device busy time over the unprofiled and over
               the profiled wall.
  6. batch and resume - config 4 at full width (phase 3b's arguments):
               (a) one Simulator after its warm-up; publish_batch([4, 5, 6]),
               the same with pad_to=4, and three publish() calls, each from
               a copy of the same state: records and every SimState leaf
               bitwise equal; prints each wall and its launches, fails if
               the gather never launched. (b) warm-up, message 1,
               save_checkpoint; then `run <3b positionals> --resume <file>`
               must write phase 3b's latencies1 byte for byte; prints the
               save and load seconds and the file's size. (c) at 2048
               peers (4 fragments) a checkpoint written on CUDA resumes on
               CUDA and on the CPU to byte-identical outputs.
  3c. lossy parity - lossy topologies (packet_loss 0.05) at 2048 peers,
               3 messages, CUDA vs CPU, gossip-heavy as in 3b(a): tcp and
               message loss through the prefix, serial and receiver-side
               serial routes (six runs). Outputs byte-identical, engine
               counts equal and the route's engine taken, the gather
               launched on the lowered routes; two runs arm the slow-peer
               penalty (weight -1, a 5 ms threshold): its counters must
               accrue and agree. Then lost_tx from one direct publish on
               each device (the records do not carry it): message mode at
               loss 0.05 and tcp at loss 0.5 must lose copies, equally.
  3d. lossy  - config 4 as in 3b(b) with <packet_loss> 0.01 under the
               default tcp model and GOSSIPSUB_SLOW_PEER_PENALTY_WEIGHT=-1
               set for that run only: fails on an unconverged fixpoint or
               a kernel of the path that never launched; prints p50/p99
               beside 3b's lossless run, the receipts later than 3b's
               maximum, the tcp draws at u = 0 and the copies at j = 6
               (ROADMAP C2). Then (c2) the same run with every j = 6 copy
               unstalled: fails if a receipt later than 3b's maximum is
               left.
  3e. membership parity - CUDA vs CPU at 2048 peers, byte-identical
               outputs and equal engine counts: (a) 75% subscribed through
               set_subscribed, an unsubscribed publisher, 3 messages within
               the fanout TTL, then an advance past it and a fourth; (b) mix
               routing on (NUMMIX 16, MIXD 4); (c) (a) with warm_start, whose
               text must also equal (a)'s; (d) a MultiTopicSimulator of 512
               peers x 4 topics at subscribe_fraction 0.75 with one
               unsubscribed publisher (records and every state leaf).
  3f. config 3 - BASELINE config 3 (bench_configs.py:169-208) at full
               width: 10,000 peers x 4 topics, 2,000 B, 60 s warm-up, one
               exact publish per topic from its 5th subscriber, 2 s apart
               (40k stacked rows: the prefix engine, sender-side). Run twice
               (the second timed as the bench times it); prints wall,
               peer-rounds/s, coverage of the subscribers, p50/p99, topic
               health, routes and launches, then one fanout publish from an
               unsubscribed peer apart, and one publish per topic of the
               same stack in 3b(a)'s gossip-heavy setting (the prefix
               engine at 40k rows). Fails on an unconverged fixpoint or
               coverage below 1 of the subscribers.
  4. config 5 - BASELINE config 5 exactly, through the port's `run` entry:
               1,000,000 peers, 15 KB, 2 messages from peer 132, bounded
               delivery mode, a 30 s warm-up, mix routing through 4 of 128
               mix nodes. Kernel launch counts zeroed just before and read
               just after; prints each message's mix delay and publish wall,
               and the wall with outputs (the latency lines go through the
               native emitter, native/logemit.cpp);
               fails on coverage < 1, other than 2,000,000 latency lines, an
               unconverged fixpoint or a kernel of the path that never
               launched.
  4b. warm twin - the same experiment through a Simulator built with
               warm_start=True: its latencies must equal phase 4's byte for
               byte; prints both runs' gather launches and publish walls and
               the warm certified / cold-rerun counts.
  5. idle    - a 1M-peer Simulator without the mix relay (the mix-less 1M
               bounded path): set-up and warm-up timed apart, then one
               publish three times from one state as in 3b(c): device busy
               time over the unprofiled and the profiled wall. Then the same
               publish with packed_state on (bf16 cost tables): `received`
               equal, the 99th percentile of the per-peer delay gap inside
               25 ms, at most 0.2% of the receivers beyond rtol 1e-2 / atol
               25 ms and none beyond one heartbeat + 25 ms, both walls and
               one relaxation sweep in each layout; and packed
               CUDA = CPU bytes at 2048 peers on the receiver-side path.

  7. roles   - the reference harness's role workloads (kad-dht in both
               DISCOVERY modes, service discovery, the regression node,
               the connection manager): (a) CUDA vs CPU at 384 peers, every
               state leaf, record, log line and summary byte-identical
               (extended kad with a retry budget; the regression also with
               the pull budget lowered, so the gather runs); (b) each at
               10,000 peers (connmanager: the reference defaults and 4 hubs
               x 10,000 spokes): set-up and phase walls, kad lookups/s,
               the regression path's launches (counts zeroed just before
               its warm-up, read after its pings), p50/p99 and coverage,
               and peak memory. Fails on a CUDA/CPU difference, a wrong
               lookup or advertisement count, an unconverged regression
               fixpoint or a score_update that never launched.

  8. service - the resident node service (ROADMAP A12): (a)
               run_service_load (the ETH2 load generator) at 64 peers x 7
               topics over HTTP, batched, killed at tick 6 and restarted
               from its checkpoint, on CUDA and on the CPU, then sequential
               on CUDA: one records sha for all three, bit_identical on
               both devices. (b) the ETH2 mainnet mix (blocks 18,000 B,
               aggregates 3,000 B, sync 1,200 B, 64 attestation subnets of
               600 B: 67 topics) at 10,000 peers (670k rows x 40), connect_to
               10, a 15 s warm-up, 5 ticks of 1 s with 8 requests against
               batches of 4 and a queue of 16, over HTTP: batched and
               killed at tick 2 (checkpoint every 2 rounds; 12 ticks and
               tick 6 until phase 14 joined), then the same
               schedule sequential. Prints set-up, warm-up, drive and
               publish walls, requests/s, sojourn p50/p99, shed rate, depth,
               dissemination by traffic class, the checkpoint's size and
               save/load walls, launches (zeroed at the start of each run)
               and peak memory; fails unless bit_identical, batched sha =
               sequential sha, the queue bound held, 0 < shed rate < 1 and
               both kernels launched. (c), run before (b), its first
               process spawned beside (a): `python -m
               dst_libp2p_test_node_tpu_torch serve` as a process at config
               4's width (PEERS=100000, FRAGMENTS=4, --warmup-s 60,
               --checkpoint, ports 0): /health and /ready, `inject` of 3 x
               15,000 B in one burst (3 x 200), the dst_testnode_*,
               libp2p_* and dst_service_* families on /metrics, SIGTERM to
               exit 0 with the final checkpoint, then `serve --resume`
               answering /health and one more inject; prints process start
               to /ready and request to dispatch.
  9. campaign - the adversarial campaign (runtime/campaign.py):
               (a) every static scenario's run_campaign at 128 peers
               (fractions 0 and 0.2, seeds 0 and 1, flight recorder and
               trial checkpoints on), and graft flood and eclipse again
               with a recovery window (evict + px + redial), on the card
               and on the CPU: TrialResult fields, checkpoint states and
               obs sidecars bitwise; for the two recovery cases also the
               windows, rebind_graph and one censored publish leaf by
               leaf. (b) BASELINE config 6 as bench_configs.config_6
               defines it (2,048 peers), then the `attack` CLI as a
               process at its width and grid with --json and
               --metrics-out, its JSON equal to an in-process run_campaign
               of the same config; prints wall_s, trials_per_s and the
               worst attacked coverage, p50, p99 and hb_to_graylist
               against hb_budget. (c) a campaign on config 4's network
               (100,000 peers x 4 fragments of 15,000 B, exact, 60 s
               warm-up): sybil_graft_flood at fractions 0 and 0.1, seeds 0
               and 1, 20 attack and 10 recovery heartbeats (evict + px +
               redial: rebind_graph at 100k), recorder and checkpoints on;
               counts zeroed just before and read just after, both kernels
               must launch; per trial the walls by phase and the
               resilience metrics, peak memory, then the host syncs of one
               attack and one recovery window (profiled); a second run on
               the same directory resumes every attacked trial to the same
               result. (d) the service's recorder at 8(b)'s 10,000 peers
               (one topic): record_telemetry, one tick, /telemetry armed
               with curves and /metrics with the dst_sim_round_* series.
 10. campaign, the rest - faults, the adaptive attacker, the DHT adversary
               and the defense sweep: (a) at 128 peers (fractions 0 and
               0.2, seeds 0 and 1, checkpoints and the recorder on), on
               the card and on the CPU: each fault family alone and the
               three composed (graft flood; the composed partition still
               open over the publishes), the adaptive attacker on eclipse
               and graft flood with a recovery window (slot race), the DHT
               two-leg campaign (eclipse + poison + cluster, healing at
               recovery round 3): fields, checkpoint files (kad/* leaves
               included) and obs sidecars bitwise; then a
               run_defense_sweep of 2 bands x 2 weights, equal outside
               wall_s. (b) three campaigns on 9(c)'s network (100,000
               peers x 4 fragments, exact, 60 s warm-up), each fractions
               0 / 0.1 x seed 0 (seeds 0 / 1 until phase 13 joined), 20
               attack and 10 recovery heartbeats
               (evict + px + redial), checkpoints on: faults (graft flood,
               crash 2:8, partition 4:12 at 0.5, spike 0:6 of 500 ms,
               recorder on), adaptive (eclipse), dht (eclipse, lookup
               eclipse + rtable poison, healing at round 5; then resumed
               on its directory to the same result); counts zeroed just
               before and read just after each, the gather must launch;
               per trial the walls by phase (the DHT build included) and
               the resilience metrics, peak memory, then the host syncs of
               one faulted and one adaptive window. (c) at BASELINE config
               6's width (2,048 peers) the `attack` process with fault,
               DHT and adaptive flags and the `pareto` process with its
               default grid: exit 0, strict JSON, a non-empty front.
 11. round chains and the protocol arena: (a) on the card and on the
               CPU, run_fused_rounds at 512 peers, split and fused
               (benign; the adaptive attacker with the recorder; crash +
               partition + spike), every leaf the same bytes in all four
               runs, and run_arena_campaign at 128 peers without and with
               faults, equal outside wall_s. (b) on 9(c)'s network the
               reference's bench chain (3 rounds of 100 heartbeats and an
               exact publish from peers 4, 5, 6), split then fused: the
               same bytes, walls, peer-rounds/s and launches (zeroed just
               before and read just after each); then the arena probe
               (benign + sybil_graft_flood against the default adaptive
               policy, fraction 0.25, seed 0 (seeds 0 and 1 until phase
               14 joined), 20 attack heartbeats, 3 messages, flood
               publish off), gated as the reference
               gates it (benign coverage >= 0.95 for both protocols,
               episub's benign bandwidth below GossipSub's), with its
               rows, launches, peak memory and the host syncs of one
               episub adaptive window. (c) the `arena` process at 2,048
               peers: exit 0, strict JSON.
 12. the conformance gate, the plan seam and trace: (a) on the card and
               on the CPU, conformance_certificate over the canon (8
               scenarios + adaptive, faults, churn, opportunistic graft,
               gossip_fragments) at seeds 0 and 1: entries equal, clean,
               every sim state the walks compare bitwise equal; both
               mutants sim_bug on the card; the seed-0 certificate on the
               card; disseminate(return_plan=True) at 2,048 peers x 2
               fragments on the prefix and serial routes, lossless and at
               1% tcp and message loss: plan, result and state leaves
               bitwise; `trace` at 64 peers: its files equal. (b) a
               campaign on 9(c)'s network armed as 10(c)'s `attack`
               (eclipse, the default adaptive policy, 10(b)'s fault
               schedule, no DHT), fractions 0 / 0.1 x seed 0 (seeds 0
               and 1 until phase 17 joined), 20
               attack and 10 recovery heartbeats, conformance=True: the
               attached certificate clean, its scenario, adaptive and
               faults entries equal to (a)'s seed-0 ones; trials/s, the
               certificate's seconds, launches (zeroed just before, read
               just after; both must launch). (c) one exact publish of
               3d's lossy config 4 at full width without and with
               return_plan: the same result and state bytes; the plan's
               shapes and bytes, peak memory, launches. (d) `conform
               --device cuda --out` as a process (run beside (a)): exit
               0, its file the seed-0 certificate's bytes; `trace -n
               100000 --heartbeats 10 --warmup-hb 5 --profile-dir` as a
               process (run beside 9(a)): exit 0, strict JSON, 10 CSV
               rows, the profiler trace naming the score_update kernel.
 13. the tooling: (a) every contract of the registry
               (analysis/registry.py: 20 entry points at the reference's
               audit shapes) on the card and on the CPU: every output leaf
               the same bytes, the feedback checks, memory budgets and
               runtime checks clean on both. (b) microbench in-process:
               the rooflines of the 20 contracts (wall, byte bound, share,
               peak memory, host syncs, retraces within budget) and the
               sweep of both kernels' launch parameter (vmem_gather's
               blocks per SM up to its occupancy, score_update's threads
               per block in both forms; the table takes the decay-only
               form's winner) at 100k, 670k and 1M x 40, every candidate held
               against the plain version, each candidate's time, the
               winner and its share of the bound, the default launch
               within 10% of this run's phase 2 time (both L2-cold);
               --install into a temporary
               DST_TUNED_JSON. Counts zeroed just before and read just
               after. (c) 3b(c)'s config-4 exact publish from one warm
               state without and with the installed table: the same
               delays and state bytes, both walls. (d) `microbench
               --no-sweep --only disseminate/cold` as a process: its
               strict-JSON artifact (the cold publish's roofline and the
               packed A/B at 100,000 peers), its wall (run beside 10(a);
               `lint` as a process is 17(c)'s since phase 17 joined).
 14. the trial grid and the DCN campaign: (a) kad.evict_failed at
               max_fails 20 (the backoff through xlamath.exp2_f32) on a
               10,000-peer DHT table with its fail counters preset, on the
               card and on the CPU: every leaf bitwise. (b) 9(c)'s
               campaign again (a fresh checkpoint directory) on a trial
               grid of two rank processes sharing the card (started
               beside 12(a)): every trial
               field equal to 9(c)'s result (kept from phase 9, not
               rerun); the caller's launches (the benign cell) plus the
               ranks' equal to 9(c)'s, both kernels launched in each rank;
               prints trials/s both ways, each rank's start-up seconds and
               the card's idle share over the grid run (1 - nvidia-smi's
               utilization.gpu, sampled every 200 ms). (c)
               scripts/dcn_campaign_torch.py at config 6's 2,048 peers
               (run beside 7(a)): two torch.distributed processes on the
               card, merged, bit-identical to the single-process run.
               (d) 9(b)'s `attack` process again with --trial-groups 0
               (one group on one card): its JSON equal to 9(b)'s outside
               the walls.
 15. the peer mesh (runtime/sharded.py: Simulator(mesh=) over rank
               processes that each hold N/P rows, joined over gloo since
               both share the one card): (a) at 1,024 peers (exact, 2
               fragments, tcp loss 5%, churn, the serial engine) a mesh of
               2 ranks on the card against the port's one-process CPU run:
               latencies, shadowlog, summaries, every record field and
               state leaf bitwise, both kernels launched in each rank; then
               vmem_gather at a rank's shape (N/2 rows of src against the
               whole N-long t) bitwise against its plain version and timed
               at 50,000 x 40 against a 100,000 t, and score_update at a
               rank's 50,000 x 40 against its plain version, timed. (b)
               phase 3b's config 4
               on 2 ranks sharing the card: warm-up, message 1, a
               checkpoint, messages 2 and 3; latencies1 and shadowlog1
               byte-identical to 3b's, p50 / p99 / coverage / max /
               refine passes equal to 3b's stats, each rank's launches
               equal to 3b's; prints the wall and peer-rounds/s beside
               3b's, all-gathers per publish and the bytes they assemble,
               each rank's start-up and build seconds and the card's idle
               share over the run. (c) that checkpoint byte-identical to
               6(b)'s one-process file at the same point; 6(b)'s file
               loaded with mesh= and run to the end gives 3b's latencies1
               again. (d) scripts/dcn_smoke_torch.py on the card: its five
               steps, step 5 one heartbeat and one disseminate on each
               process's rows of a 64-peer mesh across the two processes,
               equal to the one-process run.
 16. the campaign on the peer mesh (runtime/campaign.py's nested grid
               and run_campaign(mesh=)), inside phase 15's mesh: (a) one
               2 x 2 grid of 4 ranks sharing the card (gloo), each
               trial's 128 rows over its group's 2 ranks, against the
               port's one-process CPU runs: 10(a)'s composed faults with
               the adaptive attacker, a recovery window and the recorder,
               10(a)'s DHT two-leg campaign (every TrialResult field,
               checkpoint file and obs sidecar bitwise) and 11(a)'s
               faulted arena (its artifact), with 4 recovery rounds
               (10(a): 8); the ranks start while the CPU runs and (c)
               go. (b) run_campaign(mesh=) on phase 15's 2 ranks
               at 9(c)'s network and full width for fraction 0.1, seed 0:
               the trial = 9(c)'s (0.1, 0) trial outside the walls, its
               checkpoint and obs sidecar = 9(c)'s files, both kernels
               launched in each rank and equally often; prints the wall
               and walls by phase beside 9(c)'s, all-gathers and their
               bytes per window and per publish, each rank's peak
               allocated memory beside 9(c)'s and the card's idle share.
               (c) the flight recorder on a 2-rank ShardedSimulator at
               2,048 peers (15(a)'s setting, a 10 s warm-up, then byte
               counters and backlogs planted in every row and 2.5 s of
               heartbeats): every last_telemetry curve bitwise the
               one-process CPU run's.
 17. the mix relay on the peer mesh and the sharding auditor, inside
               phase 15's mesh: (a) config 5's relay (NUMMIX 128, MIXD 4,
               bounded, 2 messages) at 2,048 peers from peer 1,500 (rank
               1; the mix nodes are rank 0's rows) on the 2 ranks on the
               card, on 2 CPU ranks and in one CUDA process: latencies,
               every record field and gathered state leaf byte for byte.
               (b) BASELINE config 5 at full width (1,000,000 peers, a 30
               s warm-up, 2 messages from peer 132) on the 2 ranks, built
               as `run` builds it: latencies1 = phase 4's file, the mix
               delays = phase 4's, each rank's launches = phase 4's (both
               kernels); prints the wall by part beside phase 4's, the
               all-gathers and bytes per publish per rank, each rank's
               peak beside phase 4's, the card's idle share. Then both
               kernels at a rank's shape (500k x 40 rows against a 1M t)
               against their plain versions, timed. (c, d) `lint
               --sharding --predict-rung --rung-out` as one process (run
               beside 12(a), its report read here): exit
               0, clean, 26 entry points, exactly the legacy layout's two
               GA-S001 waivers, zero cross-block bytes in the dcn
               contract, each mesh contract's collectives and each rank's
               peak; the 1,048,576-peer certificate within 10% on its
               held-out point, its verdict and every leaf's argument fit
               equal to RUNG_1M_torch.json, and the modeled HBM equal to
               the card's total memory.
 18. the validity and service twins (scripts/*_torch.py) as processes
               at their scripts' full shapes, in two groups: the Ethereum
               anchors and the muxer table beside 3 and 3b(a), the
               loss-mode A/B and the service-load twin beside 6(c) and
               3c, each group waited for before the next timed part; the
               checks come here. (a) eth_anchor (10,000 peers, 128 KB, 5
               slots), attestation_anchor (10,000 peers, 600 B),
               loss_modes_ab (seven runs at 1,000 peers) and
               muxer_sensitivity (four runs at 100 peers), each with
               --write: every key of the reference's committed artifact
               (docs/VALIDITY_ANCHOR.json, VALIDITY_ANCHOR2.json,
               LOSS_MODES.json; event_loop_calibration.json's
               muxer_sensitivity) equal field for field, its "device" the
               card; each run's launches counted from zero in its own
               process, score_update launched in each anchor run. (b)
               service_load_torch.py at its chaos shape (48 peers, one
               injected failure, killed at tick 6, --no-http) on CUDA and
               with --device cpu: exit 0 both times, bit_identical, the
               simulation keys equal.

Then one JSON line with every kernel's numbers: at 1M x 40 with
`launches` from phase 4's config-5 run, under `exact` at 100k x 40 with
`launches` from phase 3b's config-4 run, under `lossy` the same 100k x 40
numbers with `launches` from phase 3d, and the launches of phase 3f
(`config3`), 4b (`warm`), 6(a)'s unpadded batch (`batch`), 6(b)'s
resumed run (`resume`), 7(b)'s regression run (`roles`), 9(c)'s first
campaign (`campaign`), 10(b)'s three campaigns (`faults`, `adaptive`,
`dht`), 11(b)'s fused chain (`fused`, with the split chain's beside it)
and arena (`arena`), 12(b)'s campaign (`conformance_campaign`), 12(c)'s
run (`plan`), 12(d)'s trace process (`trace`, as its profiler counted
them), 13(b)'s microbench (`microbench`), 14(b)'s grid (`trial_grid`:
the ranks' sum, each rank's and the caller's), 15(b)'s mesh
(`peer_mesh`: the ranks' sum and each rank's, and each kernel's time,
plain and library times and bound at a rank's shape), 16(b)'s
campaign on the mesh (`campaign_mesh`: the ranks' sum and each rank's)
and 17(b)'s config 5 on the mesh (`mix_mesh`: the ranks' sum, each
rank's, and each kernel's times and bound at a rank's 500k x 40),
18(a)'s four twins (`validity`: their sum and each script's), and
under
`service` the 670k x 40 numbers with `launches` from 8(b)'s batched run
(and its sequential run's). Then the total run time, and last the line
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no
result; run alone, without the package beside it, it exits 2.

Machine time (PERF.md section 5 has every run): phases 1-17 took
881.3-1,206.1 s over PRs 14-17 on machines whose speed differs by up to
40%, and phase 18 made it 885.1-1,255.2 s. The smoke keeps inside its
line by starting the processes whose checks time nothing beside the
CUDA = CPU checks, which time nothing either (side_start), waiting for
them before the next timed part and checking them where the phase list
puts them: beside 3-3b(a) and 6(c)-3c phase 18's six; beside 7(a)
14(c)'s DCN campaign; beside 8(a) 8(c)'s first `serve`; beside 9(a)
12(d)'s `trace`, 9(b)'s `attack` and 15(d)'s DCN smoke; beside 10(a)
10(c)'s `attack` and `pareto` and 13(d)'s `microbench`; beside 11(a)
11(c)'s `arena` and 14(d)'s `attack --trial-groups 0`; beside 12(a)
17(c, d)'s `lint`, 12(d)'s `conform` and 14(b)'s two ranks. Earlier cuts
of depth: 8(b) at 5 ticks, 10(b), 11(b)'s arena and 12(b) at seed 0,
13(d)'s `lint` folded into 17(c) and its `microbench` cut to the cold
publish (PERF.md section 4). Held to 1,100 s (ROADMAP, Budgets), inside
the 20-minute limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, ".smoke_tmp")     # big outputs, removed at end

# vmem_gather's time at 1M x 40 before its Hopper redesign (PERF.md)
GATHER_BEFORE_MS = 0.2996
# score_update's phase-2 time before its Hopper redesign, by rows of 40
# (PERF.md section 6; back-to-back launches, L2 state undefined)
SCORE_BEFORE_MS = {1_000_000: 0.2854, 670_000: 0.1926, 100_000: 0.0425}

# H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA's H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FULL_N = 1_000_000
FULL_WARMUP_S = 30.0
PARITY_N = 2048
# run.sh positionals of the mix-less 1M run (phase 5): config 5's topology
# (anchor_stages 5, 50-150 Mbit, 40-130 ms, 15 KB, 2 s spacing)
FULL_ARGS = ["1", str(FULL_N), "15000", "1", "3", "50", "150", "40", "130",
             "5", "0.0", "4", "0", "2000"]
# BASELINE config 5 (bench_configs.py:228-234): 2 messages from peer 4 +
# NUMMIX, relayed through MIXD 4 of the 128 mix nodes, bounded mode
C5_ARGS = ["1", str(FULL_N), "15000", "1", "2", "50", "150", "40", "130",
           "5", "0.0", "132", "0", "2000"]
C5_FLAGS = ["--delivery-mode", "bounded", "--warmup-s", str(FULL_WARMUP_S),
            "--use-mix", "--num-mix", "128", "--mix-d", "4"]
# BASELINE config 3 (bench_configs.py:169-208)
C3_N = 10_000
C3_TOPICS = ("blocks", "attestations", "aggregates", "sync")
# BASELINE config 4 (bench_configs.py:211-225), the exact rung: 100k peers,
# 4 fragments of a 15 KB message, churn 0.001 per heartbeat, 60 s warm-up
EXACT_N = 100_000
EXACT_ARGS = ["1", str(EXACT_N), "15000", "4", "3", "50", "150", "40", "130",
              "5", "0.0", "4", "0", "2000"]
EXACT_CHURN = 0.001
EXACT_WARMUP_S = 60.0
# the lossy config-4 run: packet_loss 0.01 under the default tcp model,
# with the slow-peer penalty armed (weight -1) for that run only
LOSSY_ARGS = list(EXACT_ARGS)
LOSSY_ARGS[10] = "0.01"
LOSSY_ENV = {"GOSSIPSUB_SLOW_PEER_PENALTY_WEIGHT": "-1"}
# phase 8(b): the ETH2 mainnet topic mix (3 + 64 attestation subnets = 67
# topics) at the vacp2p/10ksim scale, stacked as 670,000 virtual peers
SVC_N = 10_000
SVC_SUBNETS = 64
SVC_ROWS = SVC_N * (3 + SVC_SUBNETS)
# (5 ticks, killed at tick 2, since phase 14 joined the smoke: 12 ticks
# and tick 6 before; PERF.md section 4 lists the cut)
SVC_LOAD = dict(n_peers=SVC_N, subnets=SVC_SUBNETS, connect_to=10,
                warmup_s=15.0, seed=0, ticks=5, per_tick=8, tick_ms=1000.0,
                msg_scale=1.0, max_queue_depth=16, max_batch=4,
                via_http=True)
SVC_KILL_TICK = 2
# phase 8(a): the same load generator at 64 peers, CUDA against the CPU
SVC_PARITY = dict(n_peers=64, subnets=4, connect_to=6, warmup_s=10.0,
                  seed=0, ticks=12, per_tick=4, tick_ms=150.0,
                  max_queue_depth=8, max_batch=2, via_http=True)
# phase 8(c): `serve` at BASELINE config 4's width
SERVE_ENV = {"PEERS": str(EXACT_N), "FRAGMENTS": "4"}
SERVE_FLAGS = ["--warmup-s", "60"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------- side processes

# processes (the port's CLI, its scripts) whose checks are equalities and
# counts, not rates: each is started beside one of the phases' CUDA = CPU
# checks (9(a), 10(a), 11(a), 12(a), which time nothing either) and waited
# for before the next timed part, so the two overlap
_SIDE: dict = {}


def port_cmd(*args):
    """`python -m dst_libp2p_test_node_tpu_torch *args`."""
    return [sys.executable, "-m", "dst_libp2p_test_node_tpu_torch", *args]


def side_start(name, cmd, env=None, timeout=600):
    """Start `cmd` in the checkout; a thread waits for it (killed with its
    children at `timeout`) and keeps its CompletedProcess and wall."""
    t0 = time.time()
    proc = subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    done = {}

    def wait():
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            _kill_tree(proc.pid)
            out, err = proc.communicate()
            err += f"\n(killed at its {timeout} s limit)"
        done["proc"] = subprocess.CompletedProcess(proc.args,
                                                   proc.returncode, out, err)
        done["wall"] = time.time() - t0

    thread = threading.Thread(target=wait, name=f"side-{name}", daemon=True)
    thread.start()
    _SIDE[name] = (proc, thread, done)


def side_wait(name):
    """(CompletedProcess, wall s) of side process `name`, once it ended."""
    _proc, thread, done = _SIDE[name]
    thread.join()
    return done["proc"], done["wall"]


@contextlib.contextmanager
def shared_cores():
    """Half this process's intra-op threads for a CUDA = CPU check that
    side processes run beside: with all of them the check's CPU half ran
    2-3x slower on the cores the side processes kept busy (PERF.md section
    6). The CPU results are the same bytes at any thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, n // 2))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def side_join(tag, names, beside):
    """Wait for the side processes `names` started beside the check
    `beside`; prints how long the wait took beyond that check. Their
    checks stay in their own phases."""
    t0 = time.time()
    for name in names:
        side_wait(name)
    print(f"[{tag}] waited {time.time() - t0:.1f} s for {', '.join(names)}"
          f" after {beside}")


def _kill_tree(pid):
    """SIGKILL `pid` and every process below it (a side process's rank
    processes too), read from /proc."""
    kids: dict = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            kids.setdefault(ppid, []).append(int(d))
    todo = [pid]
    while todo:
        p = todo.pop()
        todo += kids.get(p, [])
        try:
            os.kill(p, signal.SIGKILL)
        except OSError:
            pass


def side_stop():
    """Kill every side process still running (after a failed phase), and
    close 14(b)'s trial grid if it was started and not used."""
    for proc, thread, _ in _SIDE.values():
        if proc.poll() is None:
            _kill_tree(proc.pid)
        thread.join()
    pool = _GRID14.pop("pool", None)
    if pool is not None:
        with contextlib.suppress(Exception):
            _GRID14.pop("started").result()
        pool.close()


def cuda_ms(fn, iters=20):
    """Mean ms per call over `iters` L2-cold calls after a warm-up: the
    card's L2 flushed before each call, each call between its own pair of
    CUDA events (runtime/microbench.mean_launch_s)."""
    from dst_libp2p_test_node_tpu_torch.runtime.microbench import (
        mean_launch_s)

    fn()
    torch.cuda.synchronize()
    dev = torch.device("cuda", torch.cuda.current_device())
    return mean_launch_s(fn, iters, dev) * 1e3


def paired_ms(plain, kernel):
    """Time in turns (plain, kernel, kernel, plain); min of each pair."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), \
        cuda_ms(plain)
    return min(k1, k2), min(p1, p2)


def device_time(prof, spans=("disseminate.fast_pipeline",
                             "disseminate.refinement")):
    """Kernel time of a torch.profiler run and its split by the port's
    record_function spans. The spans also appear as device rows (their
    extent on the GPU timeline); they are not kernels, so they are left
    out of the busy time. Returns (busy_us, top kernel rows, {span: (host
    wall us, GPU extent us, kernel us inside)})."""
    from torch.autograd import DeviceType

    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if e.name not in spans]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in spans),
                  key=lambda e: -e.self_device_time_total)
    split = {}
    for name in spans:
        host = sum(e.time_range.elapsed_us() for e in evs
                   if e.name == name and e.device_type == DeviceType.CPU)
        ranges = [e.time_range for e in dev if e.name == name]
        inside = sum(k.time_range.elapsed_us() for k in kernels
                     if any(r.start <= k.time_range.start < r.end
                            for r in ranges))
        split[name] = (host, sum(r.elapsed_us() for r in ranges), inside)
    return busy, rows, split


def profile_publish(sim, publisher):
    """The same publish three times from one state: to warm up, timed,
    then under torch.profiler. disseminate returns a new state and leaves
    its input alone, so putting the state back repeats the same work; the
    delays must agree. Returns (walls in s, profiler, last record, engine
    counts of the last publish)."""
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis

    s0 = sim.state
    walls, recs, prof = [], [], None
    for profiled in (False, False, True):
        sim.state = s0
        dis.reset_engine_counts()
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.time()
            recs.append(sim.publish(publisher))
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    for rec in recs[1:]:
        check(np.array_equal(rec.delays_ms, recs[0].delays_ms),
              "a publish repeated from the same state gave other delays")
    return walls, prof, recs[-1], dict(dis.engine_counts)


def bound_ms(nbytes, flops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1

def phase_build():
    from dst_libp2p_test_node_tpu_torch.native import build

    t0 = time.time()
    paths = build.build()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s: "
          + ", ".join(os.path.relpath(p, ROOT) for p in paths.values()))
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


# ---------------------------------------------------------------- phase 2

def _gather_inputs(n, c, gen, dev, batch=None):
    shape = (n, c) if batch is None else (batch, n, c)
    t_shape = (n,) if batch is None else (batch, n)
    t = torch.rand(t_shape, generator=gen, device=dev) * 4000.0
    t[..., ::7] = 3.4e38                         # unreached senders
    src = torch.randint(0, n, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    pad = torch.rand(shape, generator=gen, device=dev) < 0.1
    src = torch.where(pad, -1, src).to(torch.int32)
    return t, src


def _recv_constants(src, gen, dev):
    """Synthetic per-slot constants of one fixpoint around `src` (mesh and
    gossip edges mixed, millisecond-scale offsets)."""
    from dst_libp2p_test_node_tpu_torch.parallel.exchange import (
        RecvConstants)

    def ms(lo, hi, shape=src.shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    return RecvConstants(
        src=src, a_ms=ms(40.0, 400.0), g_ms=ms(120.0, 800.0),
        g_off=ms(0.0, 1000.0), phase=ms(0.0, 1000.0), u_ms=ms(0.0, 3000.0),
        flags=torch.randint(0, 4, src.shape, generator=gen, device=dev,
                            dtype=torch.int8),
        rx_c=ms(0.0, 100.0, src.shape[:1]),
        proc_ms=torch.tensor(1.0, device=dev),
        hb_ms=torch.tensor(1000.0, device=dev))


def phase_kernels(dev):
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops.state import SimParams
    from dst_libp2p_test_node_tpu_torch.parallel import exchange

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # -- vmem_gather: bitwise, plain / batched / shared-t batched -------------
    shapes = ((999, 37), (31, 7), (1, 1), (0, 40), (EXACT_N, 40),
              (SVC_ROWS, 40), (FULL_N, 40))
    held = {}
    for n, c in shapes:
        t, src = _gather_inputs(max(n, 1), c, gen, dev)
        src = src[:n]
        held[n] = t, src
        check(torch.equal(vg.vmem_gather(t, src), vg.vmem_gather_ref(t, src)),
              f"vmem_gather != plain at {n}x{c}")
        if n < 2:
            continue
        tb, srcb = _gather_inputs(n, c, gen, dev, batch=3)
        check(torch.equal(vg.vmem_gather(tb, srcb),
                          vg.vmem_gather_ref(tb, srcb)),
              f"batched vmem_gather != plain at 3x{n}x{c}")
        check(torch.equal(vg.vmem_gather(t, srcb),
                          vg.vmem_gather_ref(t, srcb)),
              f"shared-t vmem_gather != plain at 3x{n}x{c}")
    torch.cuda.synchronize()

    def time_gather(t, src):
        ms, plain = paired_ms(lambda: vg.vmem_gather_ref(t, src),
                              lambda: vg.vmem_gather(t, src))
        lib = cuda_ms(lambda: t[src.clamp_min(0)])
        b, by = bound_ms(src.numel() * 4 + t.numel() * 4 + src.numel() * 4)
        return dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                    library_ms=lib)

    at_exact = time_gather(*held[EXACT_N])
    at_svc = time_gather(*held[SVC_ROWS])
    t, src = held[FULL_N]
    at_full = time_gather(t, src)
    src_sorted = src.flatten().sort().values.view_as(src).contiguous()
    sorted_ms = cuda_ms(lambda: vg.vmem_gather(t, src_sorted))
    consts = _recv_constants(src, gen, dev)
    sweep_ms = cuda_ms(lambda: exchange._inc_from(t, consts).amin(dim=-1))
    out["vmem_gather"] = dict(
        name="vmem_gather", route="cuda",
        source="dst_libp2p_test_node_tpu_torch/native/csrc/vmem_gather.cu",
        replaces="dst_libp2p_test_node_tpu/native/vmem_gather.py:87",
        max_abs_err=0.0, **at_full, shape=[FULL_N, 40],
        exact=dict(at_exact, shape=[EXACT_N, 40]),
        service=dict(at_svc, shape=[SVC_ROWS, 40]),
        sorted_src_ms=sorted_ms, sweep_ms=sweep_ms)
    print(f"[kernels] vmem_gather bitwise at "
          + ", ".join(f"{n}x{c}" for n, c in shapes)
          + " (plain; batched and shared t where n > 1)")
    for (n, c), at in (((EXACT_N, 40), at_exact), ((SVC_ROWS, 40), at_svc),
                       ((FULL_N, 40), at_full)):
        print(f"[kernels] vmem_gather at {n}x{c}: {at['ms']:.4f} ms vs plain "
              f"{at['plain_ms']:.4f} ms, t[src.clamp_min(0)] "
              f"{at['library_ms']:.4f} ms, bound {at['bound_ms']:.4f} ms "
              f"({at['bound_by']})")
    print(f"[kernels] vmem_gather at {FULL_N}x40: sorted src {sorted_ms:.4f} "
          f"ms (same bytes, sequential t reads), before the redesign "
          f"{GATHER_BEFORE_MS} ms; one whole sweep (_inc_from + row min) "
          f"{sweep_ms:.4f} ms, the gather {at_full['ms'] / sweep_ms:.1%} of "
          f"it")

    # -- score_update, both forms: counters bitwise, score rtol 1e-5 / atol
    # 1e-6 --------------------------------------------------------------
    scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                          device=dev)
    err = 0.0

    def counters(n, c):
        return (torch.rand((n, c), generator=gen, device=dev) * 3.0,
                torch.rand((n, c), generator=gen, device=dev) * 0.5)

    labels = []

    def held(label, fmd, slow):
        nonlocal err
        labels.append(label)
        params = SimParams(n=max(fmd.shape[0], 1), capacity=fmd.shape[1],
                           slow_weight=-10.0)
        want = su.score_update_ref(fmd, slow, scales, params)
        got = su.score_update(fmd, slow, scales, params)
        dec = su.score_update(fmd, slow, scales, params, with_score=False)
        check(dec[2] is None, f"score_update decay-only gave a score at "
              f"{label}")
        for form, out in (("three-output", got), ("decay-only", dec)):
            check(torch.equal(out[0], want[0]),
                  f"score_update {form} fmd at {label}")
            check(torch.equal(out[1], want[1]),
                  f"score_update {form} slow at {label}")
        check(torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-6),
              f"score_update score at {label}")
        if want[2].numel():
            err = max(err, float((got[2] - want[2]).abs().max()))
        return params

    for n, c in ((1000, 37), (999, 37), (0, 40)):
        held(f"{n}x{c}", *counters(n, c))
    base_f, base_s = counters(1001, 37)
    held("x[1:] views of 1001x37 (not 16-byte aligned: the scalar loop)",
         base_f[1:], base_s[1:])
    held("fmd x[1:] of 1001x37 against slow x[2:] of 1002x37", base_f[1:],
         counters(1002, 37)[1][2:])
    timed, decay = {}, {}
    for n in (EXACT_N, SVC_ROWS, FULL_N):
        fmd, slow = counters(n, 40)
        params = held(f"{n}x40", fmd, slow)
        torch.cuda.synchronize()
        ms, plain = paired_ms(
            lambda: su.score_update_ref(fmd, slow, scales, params),
            lambda: su.score_update(fmd, slow, scales, params))
        b, by = bound_ms(fmd.numel() * 4 * 5 + 8, flops=fmd.numel() * 7.0)
        timed[n] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=None)
        ms, plain = paired_ms(
            lambda: su.decay_ref(fmd, slow, scales, params),
            lambda: su.score_update(fmd, slow, scales, params,
                                    with_score=False))
        b, by = bound_ms(fmd.numel() * 4 * 4 + 8, flops=fmd.numel() * 4.0)
        decay[n] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=None)
        del fmd, slow
    out["score_update"] = dict(
        name="score_update", route="cuda",
        source="dst_libp2p_test_node_tpu_torch/native/csrc/score_update.cu",
        replaces="dst_libp2p_test_node_tpu/native/score_update.py:90",
        max_abs_err=err, **timed[FULL_N], shape=[FULL_N, 40],
        exact=dict(timed[EXACT_N], shape=[EXACT_N, 40]),
        service=dict(timed[SVC_ROWS], shape=[SVC_ROWS, 40]),
        decay_only={str(n): at for n, at in decay.items()})
    print(f"[kernels] score_update, three-output and decay-only forms: "
          f"counters bitwise, score max |err| {err:g} at "
          + ", ".join(labels))
    for n in timed:
        for form, at in (("three-output", timed[n]),
                         ("decay-only", decay[n])):
            before = (f"; before the redesign {SCORE_BEFORE_MS[n]} ms "
                      f"(PERF.md, back-to-back launches, not L2-cold)"
                      if form == "three-output" else "")
            print(f"[kernels] score_update {form} at {n}x40 (L2-cold): "
                  f"{at['ms']:.4f} ms vs plain {at['plain_ms']:.4f} ms, "
                  f"bound {at['bound_ms']:.4f} ms ({at['bound_by']}), "
                  f"share {at['bound_ms'] / at['ms']:.1%}{before}")
    return out


# ---------------------------------------------------------------- phase 3

def _outputs(sim):
    from dst_libp2p_test_node_tpu_torch.runtime.bandwidth import (
        shadowlog_lines)

    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return (buf.getvalue(), "\n".join(shadowlog_lines(sim.traffic())),
            sim.summary_report() + sim.bandwidth_report())


def phase_parity(dev):
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import pull
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=1,
                      messages=3, delay_seconds=2.0)
    cfg = ExperimentConfig(topo=topo, seed=3, warmup_s=30.0,
                           serialize_answers=False)
    saved = pull._MAX_INTERMEDIATE_BYTES
    pull._MAX_INTERMEDIATE_BYTES = 1     # force the receiver-side path
    try:
        before = vg.launches
        t0 = time.time()
        sim_gpu = Simulator(cfg, device=dev)
        sim_gpu.run()
        gpu_out = _outputs(sim_gpu)
        t1 = time.time()
        check(vg.launches > before, "parity run never launched vmem_gather")
        sim_cpu = Simulator(cfg, device="cpu")
        sim_cpu.run()
        cpu_out = _outputs(sim_cpu)
        t2 = time.time()
    finally:
        pull._MAX_INTERMEDIATE_BYTES = saved
    for what, a, b in zip(("latencies", "shadowlog", "summaries"),
                          gpu_out, cpu_out):
        check(a == b, f"CUDA and CPU {what} differ at {PARITY_N} peers")
    lines = gpu_out[0].count("\n")
    check(lines == 3 * PARITY_N, f"parity run wrote {lines} latency lines")
    print(f"[parity] {PARITY_N} peers, receiver-side path: latencies "
          f"({lines} lines), shadowlog and summaries byte-identical on CUDA "
          f"({t1 - t0:.1f} s) and CPU ({t2 - t1:.1f} s)")


# --------------------------------------------------------------- phase 3b

# (name, answer_queue_mode, budget lowered, engine the route must take)
EXACT_ROUTES = (("prefix", "parallel_prefix", False, "prefix"),
                ("serial", "serial", False, "serial"),
                ("serial, receiver-side", "parallel_prefix", True, "serial"))


def _exact_run(cfg, device):
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    dis.reset_engine_counts()
    sim = Simulator(cfg, device=device)
    sim.run()
    return (_outputs(sim), dict(dis.engine_counts),
            [r.refine_passes for r in sim.records],
            float(sim.state.slow_penalty.sum()))


def phase_exact_parity(dev):
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import pull
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=1,
                      messages=3, delay_seconds=2.0)
    for name, mode, lowered, engine in EXACT_ROUTES:
        cfg = ExperimentConfig(
            topo=topo, seed=3, warmup_s=30.0, answer_queue_mode=mode,
            gossipsub=GossipSubParams(flood_publish=False, d_lazy=12))
        saved = pull._MAX_INTERMEDIATE_BYTES
        if lowered:
            pull._MAX_INTERMEDIATE_BYTES = 1
        try:
            before = vg.launches
            t0 = time.time()
            gpu_out, gpu_counts, passes, _ = _exact_run(cfg, dev)
            t1 = time.time()
            gathers = vg.launches - before
            cpu_out, cpu_counts, _, _ = _exact_run(cfg, "cpu")
            t2 = time.time()
        finally:
            pull._MAX_INTERMEDIATE_BYTES = saved
        for what, a, b in zip(("latencies", "shadowlog", "summaries"),
                              gpu_out, cpu_out):
            check(a == b, f"exact mode, {name} route: CUDA and CPU {what} "
                  f"differ at {PARITY_N} peers")
        check(gpu_counts == cpu_counts,
              f"{name} route: engine counts {gpu_counts} on CUDA, "
              f"{cpu_counts} on the CPU")
        check(gpu_counts[engine] > 0,
              f"{name} route never ran the {engine} engine: {gpu_counts}")
        check(not lowered or gathers > 0,
              f"{name} route never launched vmem_gather")
        print(f"[exact] {PARITY_N} peers, {name} route: latencies, shadowlog "
              f"and summaries byte-identical on CUDA ({t1 - t0:.1f} s) and "
              f"CPU ({t2 - t1:.1f} s); engines {gpu_counts}, refine passes "
              f"{passes}, vmem_gather launches {gathers}")


class TcpDraws:
    """Stands in for ops.disseminate.loss_draws during one run (ROADMAP
    C2): returns what it returns and counts the run's tcp draws at u = 0
    (over every (fragment, slot) draw) and its copies at retry count
    j = 6 (on lossy edges); with `force_j6` every j = 6 copy arrives
    without its stall (63 RTOs), as a j = 0 copy would."""

    def __init__(self, force_j6=False):
        self.force_j6 = force_j6
        self.u0 = 0
        self.j6 = 0
        self.j_hist = None

    def __enter__(self):
        from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis

        self._orig = dis.loss_draws
        dis.loss_draws = self._draws
        return self

    def __exit__(self, *exc):
        from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis

        dis.loss_draws = self._orig

    def _draws(self, k_loss, loss_edge, lat_edge, fragments, loss_mode):
        from dst_libp2p_test_node_tpu_torch import prng
        from dst_libp2p_test_node_tpu_torch.ops.xlamath import log_f32

        survive, retx = self._orig(k_loss, loss_edge, lat_edge, fragments,
                                   loss_mode)
        if loss_mode != "tcp":
            return survive, retx
        u = prng.uniform(k_loss, (fragments, *loss_edge.shape))
        lossy = (loss_edge > 0.0).expand_as(u)
        p = torch.clamp(loss_edge, 1e-9, 1.0 - 1e-9)
        j = torch.floor(log_f32(torch.clamp_min(u, 1e-12)) / log_f32(p))
        j = torch.clamp(torch.where(lossy, j, 0.0), 0.0, 7.0)
        six = lossy & (j == 6.0)
        self.u0 += int((u == 0.0).sum())
        self.j6 += int(six.sum())
        hist = torch.bincount(j[lossy].long(), minlength=8).cpu()
        self.j_hist = hist if self.j_hist is None else self.j_hist + hist
        if self.force_j6:
            retx = torch.where(six, torch.zeros_like(retx), retx)
        return survive, retx


def _late_peers(path, limit):
    """Receipts in a latencies file later than `limit` ms, and the
    per-message maxima."""
    late, maxima = 0, {}
    with open(path) as f:
        for line in f:
            head, ms = line.rsplit(" milliseconds: ", 1)
            msg, d = head.rsplit(":", 1)[1], int(ms)
            maxima[msg] = max(maxima.get(msg, d), d)
            late += d > limit
    return late, list(maxima.values())


def phase_config4(dev, tag, args, env=None, lossless=None, tcp=None):
    """BASELINE config 4 through `run` in the default (exact) delivery
    mode with the run.sh positionals `args` and the environment `env` set
    for that run only; counts zeroed just before and read just after.
    Fails on an unconverged fixpoint or a kernel of the path that never
    launched. Returns (launches, stats); with `lossless` (phase 3b's
    stats) it prints p50/p99 beside it, and the receipts later than its
    maximum; with `tcp` (a TcpDraws) the run's u = 0 draws and j = 6
    copies."""
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis

    env = env or {}
    os.makedirs(SCRATCH, exist_ok=True)
    prefix = os.path.join(SCRATCH, f"{tag}_")
    argv = ["run", *args, "--churn", str(EXACT_CHURN),
            "--warmup-s", str(EXACT_WARMUP_S), "--out-prefix", prefix,
            "--stats-json"]
    print(f"[{tag}] {''.join(f'{k}={v} ' for k, v in env.items())}python "
          f"-m dst_libp2p_test_node_tpu_torch {' '.join(argv)}  (BASELINE "
          f"config 4, packet_loss {args[10]}, default delivery mode)")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vg.launches = 0
        su.launches = 0
        dis.reset_engine_counts()
        t0 = time.time()
        with (tcp or contextlib.nullcontext()):
            rc = cli.main(argv)
        wall_total = time.time() - t0
        launches = {"vmem_gather": vg.launches, "score_update": su.launches}
        engines = dict(dis.engine_counts)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"{tag} run exited {rc}")
    with open(prefix + "stats1.json") as f:
        stats = json.load(f)
    stats["peak_bytes"] = peak
    check(stats["delivery_mode"] == "exact",
          f"{tag} run took {stats['delivery_mode']} delivery mode")
    beside = ""
    if lossless is not None:
        late, maxima = _late_peers(prefix + "latencies1",
                                   lossless["max_latency_ms"])
        stats["late_receipts"], stats["maxima"] = late, maxima
        beside = (f" (lossless phase 3b: p50 {lossless['p50_ms']:.3f} ms, "
                  f"p99 {lossless['p99_ms']:.3f} ms, coverage "
                  f"{lossless['coverage'] / EXACT_N}, max "
                  f"{lossless['max_latency_ms']} ms); per-message maxima "
                  f"{maxima} ms, {late} receipts later than the lossless max")
    if tcp is not None:
        stats["u0"], stats["j6"] = tcp.u0, tcp.j6
        beside += (f"; tcp draws at u = 0: {tcp.u0}, copies at j = 6: "
                   f"{tcp.j6}{' (forced to no stall)' if tcp.force_j6 else ''}"
                   f", lossy-edge draws by j 0-7: {tcp.j_hist.tolist()}")
    print(f"[{tag}] config 4: wall {stats['wall_s']:.3f} s (simulation), "
          f"{wall_total:.3f} s with outputs; peer-rounds/s "
          f"{stats['peer_rounds_per_sec']:.1f}; coverage "
          f"{stats['coverage'] / EXACT_N} (churn: need not be 1); p50 "
          f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms{beside}; "
          f"converged {stats['converged']}; engines {engines}; refine "
          f"passes {stats['refine_passes']}; launches {launches}; peak "
          f"memory {peak / 2**30:.2f} GiB")
    check(stats["converged"], f"a {tag} config-4 fixpoint hit its cap")
    check(sum(engines[k] for k in dis.ROUTES) - engines["prefix_fallback"]
          == 3, f"engine counts {engines} do not add up to 3 messages")
    for name, count in launches.items():
        check(count > 0, f"the {tag} path never launched {name}")
    return launches, stats


def phase_c2(dev, lossless, lossy):
    """ROADMAP C2: phase 3d again with every j = 6 copy forced to arrive
    without its stall. The receipts later than the lossless maximum that
    remain are the ones no j = 6 copy explains."""
    forced = TcpDraws(force_j6=True)
    _, stats = phase_config4(dev, "c2", LOSSY_ARGS, LOSSY_ENV, lossless,
                             forced)
    check(forced.j6 == lossy["j6"] and forced.u0 == lossy["u0"],
          "the forced rerun drew other u = 0 / j = 6 counts than 3d")
    check(stats["late_receipts"] == 0,
          f"{stats['late_receipts']} receipts later than the lossless max "
          f"that no j = 6 copy explains (ROADMAP C2)")
    print(f"[c2] 3d: {lossy['u0']} tcp draws at u = 0, {lossy['j6']} "
          f"copies at j = 6, {lossy['late_receipts']} receipts later than "
          f"the lossless max {lossless['max_latency_ms']} ms (maxima "
          f"{lossy['maxima']}); with those copies unstalled: "
          f"{stats['late_receipts']} (maxima {stats['maxima']})")
    return stats


def phase_exact_idle(dev):
    """One config-4 exact publish: warm, timed apart, then the same
    publish under the profiler: the disseminate spans, host syncs, device
    idle share against the unprofiled and the profiled wall."""
    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = _topo_from_fields(dict(zip(RUN_SH_PARAMS, EXACT_ARGS)))
    cfg = ExperimentConfig(topo=topo, warmup_s=EXACT_WARMUP_S,
                           churn_down_per_hb=EXACT_CHURN,
                           churn_up_per_hb=EXACT_CHURN / 2)
    t0 = time.time()
    sim = Simulator(cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    sim.warmup()
    torch.cuda.synchronize()
    t2 = time.time()
    (first, wall, wall_prof), prof, rec, engines = profile_publish(
        sim, cfg.publisher_id)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    busy_us, top, split = device_time(prof)
    print(f"[exact] config 4 split: Simulator set-up {t1 - t0:.3f} s; "
          f"warm-up of {EXACT_WARMUP_S:g} heartbeats {t2 - t1:.3f} s; one "
          f"publish {first:.3f} s the first time, {wall:.3f} s repeated "
          f"from the same state, {wall_prof:.3f} s under the profiler "
          f"(engines {engines}, {rec.refine_passes} refine passes); host "
          f"syncs (aten::_local_scalar_dense) {syncs}")
    if busy_us <= 0:
        print("[exact] profiler recorded no device time: idle share not "
              "measured")
        return
    for name, (host, extent, inside) in split.items():
        print(f"[exact] {name} (profiled): host wall {host / 1e3:.1f} ms, "
              f"GPU extent {extent / 1e3:.1f} ms, kernels inside "
              f"{inside / 1e3:.1f} ms, idle share of the extent "
              f"{1.0 - inside / max(extent, 1e-9):.4f}")
    print(f"[exact] device busy {busy_us / 1e6:.3f} s; idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f} of the unprofiled wall, "
          f"{1.0 - busy_us / 1e6 / wall_prof:.4f} of the profiled one (the "
          f"profiler's own host cost is the difference); top device time: "
          + "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} ms"
                      for e in top[:6]))


# ---------------------------------------------------------------- phase 6

def _config4_cfg():
    """BASELINE config 4 as phase 3b's `run` arguments build it."""
    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.config.env import (
        gossipsub_params_from_env)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    return ExperimentConfig(
        topo=_topo_from_fields(dict(zip(RUN_SH_PARAMS, EXACT_ARGS))),
        gossipsub=gossipsub_params_from_env(), warmup_s=EXACT_WARMUP_S,
        churn_down_per_hb=EXACT_CHURN, churn_up_per_hb=EXACT_CHURN / 2)


def _same_records(what, want, got):
    check(len(want) == len(got), f"{what}: {len(got)} records, want "
          f"{len(want)}")
    for a, b in zip(want, got):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = (x.dtype == y.dtype and x.tobytes() == y.tobytes()
                    if isinstance(x, np.ndarray) else x == y)
            check(same, f"{what}: record field {f.name} differs")


def _same_state(what, want, got):
    from dst_libp2p_test_node_tpu_torch import interop

    bad = interop.leaf_mismatches(interop.state_to_numpy(want),
                                  interop.state_to_numpy(got))
    check(not bad, f"{what}: state leaves {bad} differ")


def phase_batch(dev):
    """6(a): config 4 after its warm-up; publish_batch([4, 5, 6]), the same
    padded to 4, and three publish() calls, each from a copy of the same
    state: records and every state leaf bitwise."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    pubs = [4, 5, 6]
    sim = Simulator(_config4_cfg(), device=dev)
    sim.warmup()
    s0 = sim.state
    rng0 = sim._msg_rng.bit_generator.state

    def from_copy(publish):
        sim.state = dataclasses.replace(
            s0, **{f.name: getattr(s0, f.name).clone()
                   for f in dataclasses.fields(s0)})
        sim._msg_rng.bit_generator.state = rng0
        sim.records = []
        torch.cuda.synchronize()
        vg.launches = 0
        su.launches = 0
        t0 = time.time()
        recs = publish()
        torch.cuda.synchronize()
        return (recs, sim.state, time.time() - t0,
                {"vmem_gather": vg.launches, "score_update": su.launches})

    runs = {
        "batch": from_copy(lambda: sim.publish_batch(pubs)),
        "batch, pad_to=4": from_copy(lambda: sim.publish_batch(pubs,
                                                               pad_to=4)),
        "sequential": from_copy(lambda: [sim.publish(p) for p in pubs]),
    }
    recs_s, state_s, _, _ = runs["sequential"]
    for name in ("batch", "batch, pad_to=4"):
        recs, state, _, _ = runs[name]
        _same_records(f"config 4 {name} vs sequential", recs_s, recs)
        _same_state(f"config 4 {name} vs sequential", state_s, state)
    for name, (recs, _, wall, launches) in runs.items():
        print(f"[batch] config 4, publishers {pubs}, {name}: {wall:.3f} s; "
              f"launches {launches}; refine passes "
              f"{[r.refine_passes for r in recs]}")
        check(launches["vmem_gather"] > 0,
              f"config 4 {name} never launched vmem_gather")
    check(all(r.converged for r in recs_s), "a batch fixpoint hit its cap")
    print("[batch] records and every state leaf bitwise equal: batch, "
          "padded batch and sequential publishes")
    return runs["batch"][3]


def phase_resume(dev):
    """6(b): config 4 by phase 3b's arguments, warmed up, message 1
    published and checkpointed; `run ... --resume` must write phase 3b's
    latencies1 byte for byte."""
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _config4_cfg()
    sim = Simulator(cfg, device=dev)
    sim.warmup()
    sim.publish(cfg.publisher_id)
    ck = os.path.join(SCRATCH, "config4.npz")
    torch.cuda.synchronize()
    t0 = time.time()
    save_checkpoint(sim, ck)
    t_save = time.time() - t0
    t0 = time.time()
    back = load_checkpoint(ck, device=dev)
    torch.cuda.synchronize()
    t_load = time.time() - t0
    check(back.cfg == cfg and len(back.records) == 1,
          "the loaded checkpoint is not the saved experiment")
    _same_state("config 4 checkpoint round trip", sim.state, back.state)
    del sim, back
    prefix = os.path.join(SCRATCH, "resume_")
    argv = ["run", *EXACT_ARGS, "--churn", str(EXACT_CHURN), "--warmup-s",
            str(EXACT_WARMUP_S), "--out-prefix", prefix, "--resume", ck]
    torch.cuda.synchronize()
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    rc = cli.main(argv)
    wall = time.time() - t0
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    check(rc == 0, f"the resumed run exited {rc}")
    same = (_sha256(prefix + "latencies1")
            == _sha256(os.path.join(SCRATCH, "exact_latencies1")))
    print(f"[resume] config 4 checkpoint after message 1: "
          f"{os.path.getsize(ck) / 2**20:.1f} MiB, saved in {t_save:.3f} s, "
          f"loaded in {t_load:.3f} s (graph rebuilt); python -m "
          f"dst_libp2p_test_node_tpu_torch {' '.join(argv[:15])} ... "
          f"--resume: {wall:.3f} s with outputs, launches {launches}; "
          f"latencies1 byte-identical to phase 3b's: {same}")
    check(same, "the resumed config-4 latencies differ from phase 3b's")
    for name, count in launches.items():
        check(count > 0, f"the resumed run never launched {name}")
    return launches


def phase_resume_parity(dev):
    """6(c): at 2048 peers a checkpoint written on CUDA resumes on the CPU
    to the bytes of the CUDA resume."""
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=4,
                      messages=3, delay_seconds=2.0)
    cfg = ExperimentConfig(topo=topo, seed=3, warmup_s=30.0,
                           churn_down_per_hb=EXACT_CHURN,
                           churn_up_per_hb=EXACT_CHURN / 2)
    sim = Simulator(cfg, device=dev)
    sim.warmup()
    sim.publish(cfg.publisher_id)
    ck = os.path.join(SCRATCH, "parity.npz")
    save_checkpoint(sim, ck)
    outs = []
    for where in (dev, "cpu"):
        t0 = time.time()
        back = load_checkpoint(ck, device=where)
        back.run()
        outs.append((_outputs(back), time.time() - t0))
    for what, a, b in zip(("latencies", "shadowlog", "summaries"),
                          outs[0][0], outs[1][0]):
        check(a == b, f"a CUDA checkpoint resumed on CUDA and on the CPU: "
              f"{what} differ")
    print(f"[resume] {PARITY_N} peers, 4 fragments: a checkpoint written on "
          f"CUDA resumes to byte-identical latencies, shadowlog and "
          f"summaries on CUDA ({outs[0][1]:.1f} s) and on the CPU "
          f"({outs[1][1]:.1f} s)")


# --------------------------------------------------------------- phase 3c

# (name, loss_mode, answer_queue_mode, budget lowered, engine, slow gate)
LOSSY_ROUTES = (
    ("prefix", "tcp", "parallel_prefix", False, "prefix", True),
    ("prefix", "message", "parallel_prefix", False, "prefix", False),
    ("serial", "tcp", "serial", False, "serial", False),
    ("serial", "message", "serial", False, "serial", True),
    ("serial, receiver-side", "tcp", "parallel_prefix", True, "serial",
     False),
    ("serial, receiver-side", "message", "parallel_prefix", True, "serial",
     False),
)


def _lost_tx(dev, loss, loss_mode):
    """lost_tx of one direct lossy publish at PARITY_N peers on `dev` (the
    run's records do not carry it): (total lost, total sent)."""
    from dst_libp2p_test_node_tpu_torch.config.topology import (Topology,
                                                                TopoParams)
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.ops.graph import (
        build_connection_graph)
    from dst_libp2p_test_node_tpu_torch.ops.heartbeat import run_heartbeats
    from dst_libp2p_test_node_tpu_torch.ops.state import (SimParams,
                                                          graph_arrays,
                                                          init_state)

    topo = Topology.build(TopoParams(network_size=PARITY_N, anchor_stages=5,
                                     min_bandwidth=50, max_bandwidth=150,
                                     min_latency=40, max_latency=130,
                                     packet_loss=loss))
    g = build_connection_graph(PARITY_N, 10, seed=4, max_degree=40)
    params = SimParams(n=PARITY_N, capacity=g.capacity)
    a = graph_arrays(g, dev)
    state = run_heartbeats(init_state(params, 4, dev), a["conns"], a["rev"],
                           a["out_mask"], params, 10)
    consts = [torch.as_tensor(x, device=dev) for x in (
        topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit,
        topo.packet_loss)]
    res, _ = dis.disseminate(
        state, a["conns"], a["rev"], *consts[:3], publisher=4,
        t0_ms=float(state.t_ms) + 250.0, params=params,
        payload_bytes=15000, loss_stage=consts[3], loss_mode=loss_mode)
    return int(res.lost_tx.sum()), int(res.sends.sum())


def phase_lossy_parity(dev):
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import pull
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, packet_loss=0.05,
                      msg_size_bytes=15000, num_frags=1, messages=3,
                      delay_seconds=2.0)
    for name, loss_mode, mode, lowered, engine, gate in LOSSY_ROUTES:
        # the gate-firing routes arm the slow-peer penalty with a 5 ms
        # threshold, so penalties accrue and the score gates bind
        gs = dict(flood_publish=False, d_lazy=12)
        if gate:
            gs.update(slow_peer_penalty_weight=-1.0,
                      slow_peer_penalty_threshold=0.005)
        cfg = ExperimentConfig(
            topo=topo, seed=3, warmup_s=30.0, answer_queue_mode=mode,
            loss_mode=loss_mode, gossipsub=GossipSubParams(**gs))
        saved = pull._MAX_INTERMEDIATE_BYTES
        if lowered:
            pull._MAX_INTERMEDIATE_BYTES = 1
        try:
            before = vg.launches
            t0 = time.time()
            gpu_out, gpu_counts, passes, gpu_slow = _exact_run(cfg, dev)
            t1 = time.time()
            gathers = vg.launches - before
            cpu_out, cpu_counts, _, cpu_slow = _exact_run(cfg, "cpu")
            t2 = time.time()
        finally:
            pull._MAX_INTERMEDIATE_BYTES = saved
        what = f"lossy ({loss_mode}), {name} route"
        for part, a, b in zip(("latencies", "shadowlog", "summaries"),
                              gpu_out, cpu_out):
            check(a == b, f"{what}: CUDA and CPU {part} differ at "
                  f"{PARITY_N} peers")
        check(gpu_counts == cpu_counts,
              f"{what}: engine counts {gpu_counts} on CUDA, {cpu_counts} "
              f"on the CPU")
        check(gpu_counts[engine] > 0,
              f"{what} never ran the {engine} engine: {gpu_counts}")
        check(not lowered or gathers > 0, f"{what} never launched "
              "vmem_gather")
        check(gpu_slow == cpu_slow, f"{what}: slow-peer counters differ")
        check(not gate or gpu_slow > 0.0,
              f"{what}: the armed slow-peer penalty never accrued")
        print(f"[lossy] {PARITY_N} peers, {what}: latencies, shadowlog and "
              f"summaries byte-identical on CUDA ({t1 - t0:.1f} s) and CPU "
              f"({t2 - t1:.1f} s); engines {gpu_counts}, refine passes "
              f"{passes}, vmem_gather launches {gathers}, slow-peer "
              f"counter sum {gpu_slow}")
    # the records carry no lost_tx: read it from direct publishes
    for loss, loss_mode in ((0.05, "message"), (0.5, "tcp")):
        gpu, cpu = _lost_tx(dev, loss, loss_mode), _lost_tx("cpu", loss,
                                                             loss_mode)
        check(gpu == cpu, f"lost_tx/sends {gpu} on CUDA, {cpu} on the CPU "
              f"({loss_mode}, loss {loss})")
        check(gpu[0] > 0, f"no copy lost ({loss_mode}, loss {loss})")
        print(f"[lossy] one {loss_mode} publish at loss {loss}, {PARITY_N} "
              f"peers: lost_tx {gpu[0]} of {gpu[1]} copies sent "
              f"({gpu[0] / gpu[1]:.4f}), equal on CUDA and CPU")



# --------------------------------------------------------------- phase 3e

def _run_both(dev, build, script):
    """`script(sim)` on a Simulator from `build(device)` on `dev` and on the
    CPU: ((outputs, engine counts, sim) on `dev`, the same on the CPU,
    seconds on each)."""
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis

    out, walls = [], []
    for device in (dev, "cpu"):
        dis.reset_engine_counts()
        t0 = time.time()
        sim = build(device)
        script(sim)
        walls.append(time.time() - t0)
        out.append((_outputs(sim), dict(dis.engine_counts), sim))
    return out[0], out[1], walls[0], walls[1]


def _check_same(what, gpu, cpu):
    for part, a, b in zip(("latencies", "shadowlog", "summaries"), gpu[0],
                          cpu[0]):
        check(a == b, f"{what}: CUDA and CPU {part} differ at {PARITY_N} "
              f"peers")
    check(gpu[1] == cpu[1], f"{what}: engine counts {gpu[1]} on CUDA, "
          f"{cpu[1]} on the CPU")


def phase_membership_parity(dev):
    """Fanout publish, mix relay, warm start and the multi-topic Simulator,
    each on CUDA and on the CPU."""
    from dst_libp2p_test_node_tpu_torch import interop
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.runtime.multitopic import (
        MultiTopicConfig, MultiTopicSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=1,
                      messages=3, delay_seconds=2.0)
    mask = np.random.default_rng(11).random(PARITY_N) < 0.75
    pub = int(np.nonzero(~mask)[0][0])
    fan_sizes = []

    def membership(sim):
        sim.set_subscribed(mask)
        sim.warmup()
        for i in range(3):          # 2 s apart: inside the 60 s TTL
            if i:
                sim.advance(2000.0)
            sim.publish(pub)
            fan_sizes.append(int(sim.state.fanout_mask[pub].sum()))
        sim.advance(sim.params.fanout_ttl_ms + 1000.0)
        fan_sizes.append(int(sim.state.fanout_mask[pub].sum()))
        sim.publish(pub)
        fan_sizes.append(int(sim.state.fanout_mask[pub].sum()))

    def member_cfg(warm):
        return ExperimentConfig(
            topo=topo, seed=3, warmup_s=30.0, warm_start=warm,
            gossipsub=GossipSubParams(flood_publish=False))

    # (a) fanout, then (c) the same with warm start
    texts = {}
    for name, warm in (("fanout", False), ("fanout + warm start", True)):
        fan_sizes.clear()
        gpu, cpu, t_gpu, t_cpu = _run_both(
            dev, lambda d: Simulator(member_cfg(warm), device=d), membership)
        _check_same(f"membership ({name})", gpu, cpu)
        d = member_cfg(warm).gossipsub.d
        check(fan_sizes[:5] == [d, d, d, 0, d],
              f"{name}: fanout set sizes {fan_sizes[:5]} (publish x3, "
              f"expiry, publish)")
        check(not any(r.received[pub] for r in gpu[2].records),
              f"{name}: the unsubscribed origin logged its own message")
        texts[name] = gpu[0]
        print(f"[member] {PARITY_N} peers, {name}: 4 publishes from "
              f"unsubscribed peer {pub} (fanout set {fan_sizes[:5]}), "
              f"outputs byte-identical on CUDA ({t_gpu:.1f} s) and CPU "
              f"({t_cpu:.1f} s); engines {gpu[1]}")
    check(texts["fanout"] == texts["fanout + warm start"],
          "the warm-start run's outputs differ from the cold run's")
    print("[member] warm-start outputs equal the cold run's byte for byte")

    # (b) mix relay
    mix_cfg = ExperimentConfig(topo=topo, seed=3, warmup_s=30.0,
                               uses_mix=True, num_mix=16, mix_d=4,
                               publisher_id=14, publisher_rotation=True)
    gpu, cpu, t_gpu, t_cpu = _run_both(
        dev, lambda d: Simulator(mix_cfg, device=d), lambda sim: sim.run())
    _check_same("mix relay", gpu, cpu)
    lines = gpu[0][0].count("\n")
    check(lines == 3 * PARITY_N, f"mix run wrote {lines} latency lines")
    print(f"[member] {PARITY_N} peers, mix relay (NUMMIX 16, MIXD 4, "
          f"publishers 14-16): outputs byte-identical on CUDA "
          f"({t_gpu:.1f} s) and CPU ({t_cpu:.1f} s); engines {gpu[1]}")

    # (d) the multi-topic Simulator
    mt_cfg = MultiTopicConfig(
        topo=TopoParams(network_size=512, anchor_stages=5,
                        min_bandwidth=50, max_bandwidth=150, min_latency=40,
                        max_latency=130, msg_size_bytes=2000),
        topics=C3_TOPICS, subscribe_fraction=0.75, warmup_s=30.0, seed=3)
    runs = []
    for device in (dev, "cpu"):
        dis.reset_engine_counts()
        t0 = time.time()
        sim = MultiTopicSimulator(mt_cfg, device=device)
        sim.warmup()
        recs = []
        for ti, topic in enumerate(C3_TOPICS):
            recs.append(sim.publish(
                topic, int(np.nonzero(sim.subscribed_np[ti])[0][4])))
            sim.advance(2000.0)
        unsub = int(np.nonzero(~sim.subscribed_np[0])[0][0])
        recs.append(sim.publish(C3_TOPICS[0], unsub))
        runs.append((recs, interop.state_to_numpy(sim.state),
                     dict(dis.engine_counts), time.time() - t0))
    (g_recs, g_state, g_eng, t_gpu), (c_recs, c_state, c_eng, t_cpu) = runs
    for a, b in zip(g_recs, c_recs):
        for name in ("delays_ms", "received", "sends", "copies_rx"):
            check(np.array_equal(getattr(a, name), getattr(b, name)),
                  f"multi-topic record {name} differs on CUDA and CPU")
        check((a.ihave, a.iwant, a.converged) == (b.ihave, b.iwant,
                                                  b.converged),
              "multi-topic record counters differ on CUDA and CPU")
    check(interop.leaf_mismatches(c_state, g_state) == [],
          "multi-topic state differs on CUDA and CPU")
    check(g_eng == c_eng, f"multi-topic engines {g_eng} vs {c_eng}")
    check(not g_recs[-1].received[unsub], "fanout origin logged itself")
    print(f"[member] multi-topic 512 peers x {len(C3_TOPICS)} topics, "
          f"subscribe_fraction 0.75, one publish per topic and one fanout "
          f"publish: records and every state leaf equal on CUDA "
          f"({t_gpu:.1f} s) and CPU ({t_cpu:.1f} s); engines {g_eng}")


# --------------------------------------------------------------- phase 3f

def phase_config3(dev):
    """BASELINE config 3 at full width on the card (module doc)."""
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.runtime.multitopic import (
        MultiTopicConfig, MultiTopicSimulator)

    cfg = MultiTopicConfig(
        topo=TopoParams(network_size=C3_N, anchor_stages=5,
                        min_bandwidth=50, max_bandwidth=150, min_latency=40,
                        max_latency=130, msg_size_bytes=2000, num_frags=1,
                        messages=3, delay_seconds=2.0),
        topics=C3_TOPICS, connect_to=10, subscribe_fraction=0.75,
        warmup_s=60.0, seed=0)
    t0 = time.time()
    sim = MultiTopicSimulator(cfg, device=dev)
    torch.cuda.synchronize()
    setup = time.time() - t0

    def experiment():
        sim.reset()
        sim.warmup()
        recs = []
        for ti, topic in enumerate(cfg.topics):
            pub = int(np.nonzero(sim.subscribed_np[ti])[0][4])
            recs.append(sim.publish(topic, pub))
            sim.advance(2000.0)
        torch.cuda.synchronize()
        return recs

    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        torch.cuda.synchronize()
        vg.launches = 0
        su.launches = 0
        dis.reset_engine_counts()
        t1 = time.time()
        recs = experiment()
        walls.append(time.time() - t1)
        launches = {"vmem_gather": vg.launches, "score_update": su.launches}
        engines = dict(dis.engine_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    wall = walls[-1]
    rounds = float(sim.state.t_ms) / sim.params.heartbeat_ms
    prs = C3_N * rounds * len(cfg.topics) / wall
    delays = np.concatenate([r.delays_ms[sim.subscribed_np[ti]]
                             for ti, r in enumerate(recs)])
    coverage = float(np.isfinite(delays).mean())
    fin = delays[np.isfinite(delays)]
    health = sim.topic_health()
    print(f"[config3] {C3_N} peers x {len(cfg.topics)} topics "
          f"({len(cfg.topics) * C3_N} stacked rows), subscribe_fraction "
          f"0.75, exact mode: set-up {setup:.3f} s; experiment wall "
          f"{walls[0]:.3f} s the first time, {wall:.3f} s the second "
          f"({rounds:g} rounds); peer-rounds/s {prs:.1f}; coverage of the "
          f"subscribers {coverage}; p50 {np.percentile(fin, 50):.3f} ms, "
          f"p99 {np.percentile(fin, 99):.3f} ms; health {health}; mesh "
          f"sizes {sim.mesh_sizes()}; engines {engines}; refine passes "
          f"{[r.refine_passes for r in recs]}; launches {launches}; peak "
          f"memory {peak / 2**30:.2f} GiB")
    check(all(r.converged for r in recs), "a config-3 fixpoint hit its cap")
    check(coverage >= 1.0, f"config 3 coverage {coverage} of subscribers")
    check(sum(engines[k] for k in dis.ROUTES) - engines["prefix_fallback"]
          == len(cfg.topics), f"config 3 engine counts {engines}")
    check(launches["score_update"] > 0,
          "the config-3 path never launched score_update")
    # one fanout publish from a peer outside topic 0
    unsub = int(np.nonzero(~sim.subscribed_np[0])[0][0])
    torch.cuda.synchronize()
    t1 = time.time()
    rec = sim.publish(cfg.topics[0], unsub)
    torch.cuda.synchronize()
    fan_wall = time.time() - t1
    fan_cov = float(rec.received[sim.subscribed_np[0]].mean())
    fan = int(sim.states.fanout_mask[0, unsub].sum())
    print(f"[config3] one fanout publish on {cfg.topics[0]!r} from "
          f"unsubscribed peer {unsub}: {fan_wall:.3f} s, fanout set of "
          f"{fan}, coverage of the subscribers {fan_cov}, converged "
          f"{rec.converged}, refine passes {rec.refine_passes}")
    check(rec.converged and fan_cov >= 1.0 and not rec.received[unsub],
          "the config-3 fanout publish")
    # config 3's own messages keep the fast pipeline; the same stack in the
    # gossip-heavy setting of 3b(a) sends them through the prefix engine
    # at this width (sender-side, below the pull budget)
    heavy = MultiTopicSimulator(dataclasses.replace(
        cfg, gossipsub=GossipSubParams(flood_publish=False, d_lazy=12)),
        device=dev)
    heavy.warmup()
    dis.reset_engine_counts()
    pub_walls, recs = [], []
    for ti, topic in enumerate(cfg.topics):
        torch.cuda.synchronize()
        t1 = time.time()
        recs.append(heavy.publish(
            topic, int(np.nonzero(heavy.subscribed_np[ti])[0][4])))
        torch.cuda.synchronize()
        pub_walls.append(time.time() - t1)
        heavy.advance(2000.0)
    engines = dict(dis.engine_counts)
    cov = min(float(r.received[heavy.subscribed_np[ti]].mean())
              for ti, r in enumerate(recs))
    print(f"[config3] gossip-heavy (no flood publish, D_lazy 12), one "
          f"publish per topic: engines {engines}; refine passes "
          f"{[r.refine_passes for r in recs]}; publish walls "
          f"{[round(w, 4) for w in pub_walls]} s; coverage of the "
          f"subscribers {cov}")
    check(all(r.converged for r in recs) and cov >= 1.0,
          "the gossip-heavy config-3 publishes")
    return launches


# ---------------------------------------------------------------- phase 4

@contextlib.contextmanager
def publish_recorder():
    """While open, every Simulator.publish is timed (synchronized before
    and after) and every mix relay's path delay is kept; the port itself
    is not changed."""
    from dst_libp2p_test_node_tpu_torch.runtime.sharded import (
        ShardedSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    rec = {"walls": [], "mix_ms": []}
    publish, relay = Simulator.publish, Simulator._mix_relay
    mesh_relay = ShardedSimulator._mix_relay

    def timed_publish(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = publish(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec["walls"].append(time.time() - t0)
        return out

    def kept(fn):
        def kept_relay(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            rec["mix_ms"].append(out[0])
            return out
        return kept_relay

    Simulator.publish, Simulator._mix_relay = timed_publish, kept(relay)
    ShardedSimulator._mix_relay = kept(mesh_relay)
    try:
        yield rec
    finally:
        Simulator.publish, Simulator._mix_relay = publish, relay
        ShardedSimulator._mix_relay = mesh_relay


def _sha256(path):
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def phase_main(dev):
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg

    os.makedirs(SCRATCH, exist_ok=True)
    prefix = os.path.join(SCRATCH, "c5_")
    argv = ["run", *C5_ARGS, *C5_FLAGS, "--out-prefix", prefix,
            "--stats-json"]
    print(f"[main] python -m dst_libp2p_test_node_tpu_torch "
          f"{' '.join(argv)}  (BASELINE config 5)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    with publish_recorder() as rec:
        rc = cli.main(argv)
    wall_total = time.time() - t0
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"run exited {rc}")
    with open(prefix + "stats1.json") as f:
        stats = json.load(f)
    with open(prefix + "latencies1") as f:
        lines = sum(1 for _ in f)
    digest = _sha256(prefix + "latencies1")
    coverage = stats["coverage"] / FULL_N
    print(f"[main] config 5: wall {stats['wall_s']:.3f} s (simulation), "
          f"{wall_total:.3f} s with outputs; peer-rounds/s "
          f"{stats['peer_rounds_per_sec']:.1f}; coverage {coverage}; "
          f"p50 {stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms; "
          f"converged {stats['converged']}; answer_wait_max "
          f"{stats['answer_wait_max_ms']:.3f} ms; mix path delay per "
          f"message {rec['mix_ms']} ms; publish walls "
          f"{[round(w, 4) for w in rec['walls']]} s; launches {launches}; "
          f"peak memory {peak / 2**30:.2f} GiB; {lines} latency lines")
    check(coverage >= 1.0, f"coverage {coverage} < 1")
    check(stats["converged"], "a fixpoint hit its iteration cap")
    check(lines == 2 * FULL_N, f"{lines} latency lines, want {2 * FULL_N}")
    check(len(rec["mix_ms"]) == 2 and min(rec["mix_ms"]) > 0.0,
          f"mix relay delays {rec['mix_ms']}")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
    return launches, dict(digest=digest, walls=rec["walls"],
                          mix_ms=rec["mix_ms"], wall_s=stats["wall_s"],
                          peak=peak, launches=launches)


# --------------------------------------------------------------- phase 4b

def phase_warm_twin(dev, cold):
    """Config 5 again through a Simulator with warm_start=True, built as
    the `run` entry builds it: latencies byte-identical to phase 4's."""
    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.config.env import (
        gossipsub_params_from_env)
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = _topo_from_fields(dict(zip(RUN_SH_PARAMS, C5_ARGS)))
    cfg = ExperimentConfig(
        topo=topo, gossipsub=gossipsub_params_from_env(), publisher_id=132,
        warmup_s=FULL_WARMUP_S, seed=0, uses_mix=True, num_mix=128, mix_d=4,
        serialize_answers=False, warm_start=True)
    torch.cuda.synchronize()
    vg.launches = 0
    su.launches = 0
    dis.reset_engine_counts()
    t0 = time.time()
    with publish_recorder() as rec:
        sim = Simulator(cfg, device=dev)
        sim.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    engines = dict(dis.engine_counts)
    path = os.path.join(SCRATCH, "c5_warm_latencies1")
    sim.write_latencies(path)
    same = _sha256(path) == cold["digest"]
    print(f"[warm] config 5 with warm_start: {wall:.3f} s with set-up; "
          f"publish walls {[round(w, 4) for w in rec['walls']]} s (cold, "
          f"phase 4: {[round(w, 4) for w in cold['walls']]} s); mix delays "
          f"{rec['mix_ms']} ms; warm certified {engines['warm_certified']}, "
          f"cold reruns {engines['warm_cold_rerun']}; launches {launches}; "
          f"latencies byte-identical to phase 4: {same}")
    check(same, "the warm-start config-5 latencies differ from phase 4's")
    check(engines["warm_certified"] + engines["warm_cold_rerun"] == 2,
          f"warm outcomes {engines} do not add up to 2 messages")
    check(all(r.converged for r in sim.records), "a warm fixpoint hit its cap")
    return launches



# ---------------------------------------------------------------- phase 5

def packed_parity(dev):
    """packed_state at 2048 peers, pull budget lowered (receiver-side: the
    gather on bf16-packed constants): CUDA and CPU outputs byte-identical."""
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.ops import pull
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=1,
                      messages=3, delay_seconds=2.0)
    cfg = ExperimentConfig(topo=topo, seed=3, warmup_s=30.0,
                           serialize_answers=False, packed_state=True)
    saved = pull._MAX_INTERMEDIATE_BYTES
    pull._MAX_INTERMEDIATE_BYTES = 1
    try:
        outs = []
        for where in (dev, "cpu"):
            sim = Simulator(cfg, device=where)
            sim.run()
            outs.append(_outputs(sim))
    finally:
        pull._MAX_INTERMEDIATE_BYTES = saved
    for what, a, b in zip(("latencies", "shadowlog", "summaries"), *outs):
        check(a == b, f"packed_state at {PARITY_N} peers: CUDA and CPU "
              f"{what} differ")
    print(f"[packed] {PARITY_N} peers, receiver-side, packed_state: "
          f"latencies, shadowlog and summaries byte-identical on CUDA and "
          f"CPU")


def packed_publish(sim, publisher, rec, wall):
    """The publish of phase 5 (`rec`, from sim.state) again from the same
    state with packed_state on (bf16 relative cost tables): `received`
    equal and the per-peer delay gap against rtol 1e-2 / atol 25 ms (the
    reference's own pin at its test size). A bf16-rounded heartbeat phase
    can move a gossip offer to the next heartbeat tick, so a few peers may
    exceed the pin: at most 0.2% of the receivers, none by more than one
    heartbeat plus atol, and the gap's 99th percentile inside atol. Both
    walls, and one relaxation sweep at 1M x 40 in each layout."""
    from dst_libp2p_test_node_tpu_torch.parallel import exchange

    s0, params = sim.state, sim.params
    sim.params = dataclasses.replace(params, packed_state=True)
    walls = []
    try:
        for _ in range(2):
            sim.state = s0
            torch.cuda.synchronize()
            t0 = time.time()
            got = sim.publish(publisher)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    finally:
        sim.state, sim.params = s0, params
    check(np.array_equal(got.received, rec.received),
          "packed_state changed who received the message")
    ok = rec.received
    gap = np.abs(got.delays_ms[ok] - rec.delays_ms[ok])
    beyond = int((gap > 25.0 + 1e-2 * np.abs(rec.delays_ms[ok])).sum())
    p99 = float(np.percentile(gap, 99))
    gen = torch.Generator(device=s0.device).manual_seed(1)
    t, src = _gather_inputs(FULL_N, 40, gen, s0.device)
    consts = _recv_constants(src, gen, s0.device)
    bf16 = torch.bfloat16
    packed = dataclasses.replace(
        consts, **{f: getattr(consts, f).to(bf16)
                   for f in ("a_ms", "g_ms", "g_off", "phase")})
    sweeps = [cuda_ms(lambda c=c: exchange._inc_from(t, c).amin(dim=-1))
              for c in (consts, packed, consts, packed)]
    print(f"[packed] one bounded publish at {FULL_N} peers from the same "
          f"state: unpacked {wall:.3f} s, packed_state {walls[0]:.3f} / "
          f"{walls[1]:.3f} s; received equal; delay gap p50 "
          f"{float(np.median(gap)):.3f} ms, p99 {p99:.3f} ms, max "
          f"{float(gap.max()):.3f} ms; {beyond} of {int(ok.sum())} peers "
          f"beyond rtol 1e-2 / atol 25 ms; one sweep (_inc_from + row min) "
          f"at {FULL_N}x40: f32 tables {min(sweeps[0], sweeps[2]):.4f} ms, "
          f"bf16 tables {min(sweeps[1], sweeps[3]):.4f} ms")
    check(p99 <= 25.0, f"packed_state delay gap p99 {p99:.3f} ms > 25 ms")
    check(beyond <= 0.002 * int(ok.sum()),
          f"packed_state: {beyond} of {int(ok.sum())} peers beyond rtol "
          f"1e-2 / atol 25 ms, more than 0.2%")
    worst = float(gap.max())
    check(worst <= params.heartbeat_ms + 25.0,
          f"packed_state delay gap max {worst:.3f} ms > one heartbeat "
          f"({params.heartbeat_ms} ms) + 25 ms")


def phase_idle(dev):
    """Device busy share of one 1M-peer publish (torch.profiler)."""
    from torch.autograd import DeviceType

    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = _topo_from_fields(dict(zip(RUN_SH_PARAMS, FULL_ARGS)))
    cfg = ExperimentConfig(topo=topo, warmup_s=5.0, serialize_answers=False)
    t0 = time.time()
    sim = Simulator(cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    sim.warmup()
    torch.cuda.synchronize()
    t2 = time.time()
    s0 = sim.state
    (first, wall, wall_prof), prof, rec, _ = profile_publish(
        sim, cfg.publisher_id)
    sim.state = s0
    packed_publish(sim, cfg.publisher_id, rec, wall)
    packed_parity(dev)
    print(f"[idle] at {FULL_N} peers: Simulator set-up (state, edge tables "
          f"and a copy of phase 4's connection graph from ops/graph.py's "
          f"cache) {t1 - t0:.3f} s; warm-up of 5 heartbeats "
          f"{t2 - t1:.3f} s; one publish {first:.3f} s the first time, "
          f"{wall:.3f} s repeated from the same state, {wall_prof:.3f} s "
          f"under the profiler")
    rows = prof.key_averages()
    # kernel rows only: CPU-op rows repeat the time of the kernels they
    # launched
    busy_us, top, _ = device_time(prof)
    if busy_us <= 0:
        print("[idle] profiler recorded no device time: idle share not "
              "measured")
        return None
    idle = 1.0 - busy_us / 1e6 / wall
    ops = sorted((e for e in rows if e.device_type != DeviceType.CUDA
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:12]
    print("[idle] device time by aten op: " + "; ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
        for e in ops))
    print(f"[idle] one publish at {FULL_N} peers: device busy "
          f"{busy_us / 1e6:.3f} s, idle share {idle:.4f} of the unprofiled "
          f"wall, {1.0 - busy_us / 1e6 / wall_prof:.4f} of the profiled one;"
          f" top device time: "
          + "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} ms"
                      for e in top[:6]))
    return idle


# ---------------------------------------------------------------- phase 7

# the role workloads at the 10,000-node scale of the reference's deployment
# tool; parity at ROLES_PARITY_N peers
ROLES_N = 10_000
ROLES_PARITY_N = 384
ROLES_HUB_SPOKES = 10_000


def _leaf_bytes(obj):
    from dst_libp2p_test_node_tpu_torch import interop

    return {k: (v.dtype.str, v.shape, v.tobytes())
            for k, v in interop.leaves_to_numpy(obj).items()}


def _role_outputs(kind, sim, summary):
    """Everything a role run leaves behind, as comparable bytes."""
    from dst_libp2p_test_node_tpu_torch import interop

    if kind == "connmanager":
        return (_leaf_bytes(sim), summary.trace.tobytes(), summary.report())
    out = [list(sim.lines), summary.report()]
    if kind == "kad":
        out += [[dataclasses.astuple(r) for r in sim.lookups],
                _leaf_bytes(sim.state)]
    elif kind == "servicedisco":
        out += [sim.lookup_records, sim.adv_latencies,
                _leaf_bytes(sim.kstate), _leaf_bytes(sim.store)]
    else:
        out += [[dataclasses.astuple(p) for p in sim.pings],
                _leaf_bytes(sim.kstate),
                {k: (v.dtype.str, v.tobytes()) for k, v in
                 interop.state_to_numpy(sim.sim.state).items()},
                [(r.msg_id, r.delays_ms.tobytes(), r.received.tobytes(),
                  r.sends.tobytes(), r.copies_rx.tobytes())
                 for r in sim.records()]]
    return out


def _role_run(kind, cfg, device):
    from dst_libp2p_test_node_tpu_torch.ops.connmanager import (
        run_connmanager)
    from dst_libp2p_test_node_tpu_torch.runtime.kad_runtime import (
        KadSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.regression_runtime import (
        RegressionSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.sd_runtime import SDSimulator

    if kind == "connmanager":
        summary, state = run_connmanager(cfg, device=device)
        return state, summary
    sim = {"kad": KadSimulator, "servicedisco": SDSimulator,
           "regression": RegressionSimulator}[kind](cfg, device=device)
    return sim, sim.run()


def _role_configs(n, spokes, duration_s=60.0):
    """Each workload's config at n peers (connmanager: 4 hubs x spokes)."""
    from dst_libp2p_test_node_tpu_torch.ops import connmanager as cm
    from dst_libp2p_test_node_tpu_torch.runtime import (
        kad_runtime, regression_runtime, sd_runtime)

    half, quarter = spokes // 2, spokes // 4
    return {
        "kad": kad_runtime.KadConfig(
            network_size=n, n_bootstrap=3, n_probe=min(100, n // 4),
            probe_duration_s=duration_s),
        "kad-extended": kad_runtime.KadConfig(
            network_size=n, n_bootstrap=3, n_probe=min(100, n // 4),
            probe_duration_s=duration_s, discovery="extended"),
        "servicedisco": sd_runtime.SDConfig(
            network_size=n, n_bootstrap=2, n_advertisers=n // 10,
            n_discoverers=n // 10, services=["svc-a", "svc-b", "svc-c"],
            duration_s=int(duration_s)),
        "regression": regression_runtime.RegressionConfig(
            network_size=n, n_bootstrap=1, connect_to=10,
            discovery_rounds=3, msg_size=1000, messages=10,
            delay_seconds=4.0, ping_rounds=2),
        "connmanager": cm.ConnManagerConfig(),
        "connmanager-4hub": cm.ConnManagerConfig(
            params=cm.ConnManagerParams(n_hubs=4, n_peers=spokes),
            n_none=half, n_aggressive=quarter,
            n_before_grace=spokes - half - quarter, duration_s=120),
    }


def phase_roles_parity(dev):
    """7(a): each role workload on CUDA and on the CPU at ROLES_PARITY_N
    peers (the regression receiver-side too): every state leaf, record,
    log line and summary byte-identical."""
    from dst_libp2p_test_node_tpu_torch.ops import pull

    cfgs = _role_configs(ROLES_PARITY_N, ROLES_PARITY_N, duration_s=20.0)
    cfgs["kad-extended"].evict_max_fails = 3
    cfgs["kad-extended"].evict_backoff_ms = 500.0
    runs = [(name, cfg, False) for name, cfg in cfgs.items()]
    runs.append(("regression", cfgs["regression"], True))
    budget = pull._MAX_INTERMEDIATE_BYTES
    for name, cfg, recv_side in runs:
        kind = name.split("-")[0]
        walls, outs = [], []
        try:
            if recv_side:
                pull._MAX_INTERMEDIATE_BYTES = 1
            for device in (dev, "cpu"):
                t0 = time.time()
                sim, summary = _role_run(kind, dataclasses.replace(cfg),
                                         device)
                walls.append(time.time() - t0)
                outs.append(_role_outputs(kind, sim, summary))
        finally:
            pull._MAX_INTERMEDIATE_BYTES = budget
        tag = name + (" receiver-side" if recv_side else "")
        check(outs[0] == outs[1], f"roles {tag}: CUDA and CPU differ at "
              f"{ROLES_PARITY_N} peers")
        print(f"[roles] {tag} at {ROLES_PARITY_N} peers: CUDA = CPU "
              f"bitwise (state, records, log lines, summary); "
              f"{walls[0]:.3f} s on CUDA, {walls[1]:.3f} s on the CPU")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase_roles(dev):
    """7(b): the four workloads at full width; returns the regression
    path's kernel launches."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.ops.connmanager import (
        run_connmanager)
    from dst_libp2p_test_node_tpu_torch.runtime.kad_runtime import (
        KadSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.regression_runtime import (
        RegressionSimulator)
    from dst_libp2p_test_node_tpu_torch.runtime.sd_runtime import SDSimulator

    cfgs = _role_configs(ROLES_N, ROLES_HUB_SPOKES)
    for name in ("kad", "kad-extended"):
        torch.cuda.reset_peak_memory_stats(dev)
        sim, setup = _timed(lambda: KadSimulator(cfgs[name], device=dev))
        _, boot = _timed(sim.boot)
        _, warm = _timed(sim.warmup)
        n_warm = len(sim.lookups)
        _, probe = _timed(sim.probe)
        summary = sim.summary()
        n_look = len(sim.lookups)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[roles] {name} at {ROLES_N} peers (3 bootstraps, "
              f"{len(sim.probes)} probes, 60 s probe loop): set-up "
              f"{setup:.3f} s, boot {boot:.3f} s, warm-up {warm:.3f} s "
              f"({n_warm} lookups, {n_warm / warm:.0f} lookups/s), probe "
              f"loop {probe:.3f} s ({n_look - n_warm} lookups); "
              f"{n_look / (warm + probe):.0f} lookups/s over both; census "
              f"mean {summary.census_mean:.1f}, lookup p50/p99 "
              f"{summary.lookup_latency_ms_p50:.0f}/"
              f"{summary.lookup_latency_ms_p99:.0f} ms, hops "
              f"{summary.hops_mean:.2f}; peak memory "
              f"{peak / 2**30:.2f} GiB")
        check(summary.probe_lookups == len(sim.probes) * 12
              and summary.warmup_lookups == 20 * len(sim.normals),
              f"{name}: lookup counts {summary}")

    torch.cuda.reset_peak_memory_stats(dev)
    sim, setup = _timed(lambda: SDSimulator(cfgs["servicedisco"], device=dev))
    summary, run = _timed(sim.run)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[roles] servicedisco at {ROLES_N} peers ({ROLES_N // 10} "
          f"advertisers, {ROLES_N // 10} discoverers, 3 services, 60 s): "
          f"set-up {setup:.3f} s, "
          f"run {run:.3f} s ({summary.lookups} lookups, "
          f"{summary.lookups_failed} failed, {len(sim.adv_latencies)} "
          f"advertisements); unique providers mean "
          f"{summary.unique_peers_mean:.1f} of {summary.expected_providers};"
          f" lookup p50/p99 {summary.lookup_latency_ms_p50:.0f}/"
          f"{summary.lookup_latency_ms_p99:.0f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB")
    q = ROLES_N // 10
    check(summary.lookups == 4 * 3 * q and len(sim.adv_latencies)
          == 2 * 3 * q, f"servicedisco counts {summary}")

    torch.cuda.reset_peak_memory_stats(dev)
    sim, setup = _timed(lambda: RegressionSimulator(cfgs["regression"],
                                                    device=dev))
    _, disc = _timed(sim.discover)
    reg, build = _timed(sim.build_sim)
    torch.cuda.synchronize()
    vg.launches = 0
    su.launches = 0
    dis.reset_engine_counts()
    _, warm = _timed(reg.warmup)
    cfg = cfgs["regression"]

    def publishes():
        for i in range(cfg.messages):
            if i > 0:
                reg.advance(cfg.delay_seconds * 1000.0)
            reg.publish(cfg.n_bootstrap)

    _, pubs = _timed(publishes)

    def pings():
        for _ in range(cfg.ping_rounds):
            sim.ping_round()
            reg.advance(45_000.0)

    _, ping = _timed(pings)
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    engines = {k: v for k, v in dis.engine_counts.items() if v}
    summary = sim.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    delays = np.concatenate([r.delays_ms[r.received] for r in reg.records])
    print(f"[roles] regression at {ROLES_N} peers (1 bootstrap, connect_to "
          f"10, 3 discovery waves, 10 x 1,000 B 4 s apart, 45 s warm-up, 2 "
          f"ping rounds): set-up {setup:.3f} s, discovery {disc:.3f} s, "
          f"graph and Simulator {build:.3f} s, warm-up {warm:.3f} s, "
          f"publishes {pubs:.3f} s, pings {ping:.3f} s; coverage "
          f"{summary.coverage:.4f}, p50 {np.percentile(delays, 50):.3f} ms, "
          f"p99 {np.percentile(delays, 99):.3f} ms, mesh degree "
          f"{summary.mesh_degree_mean:.2f}, {summary.ping_count} pings; "
          f"engines {engines}; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    check(all(r.converged for r in reg.records) and len(reg.records) == 10,
          "regression: an unconverged fixpoint")
    check(launches["score_update"] > 0,
          "the regression path never launched score_update")

    for name in ("connmanager", "connmanager-4hub"):
        c = cfgs[name]
        torch.cuda.reset_peak_memory_stats(dev)
        (summary, _), wall = _timed(lambda: run_connmanager(c, device=dev))
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[roles] {name}: {c.params.n_hubs} hubs x "
              f"{c.params.n_peers} peers ({c.n_none} none / "
              f"{c.n_aggressive} aggressive / {c.n_before_grace} "
              f"before-grace), {c.duration_s} s: {wall:.3f} s; "
              f"{summary.report().splitlines()[1]}; dials {summary.dials}, "
              f"trims {summary.trims}, cycles {summary.cycles}; peak memory "
              f"{peak / 2**30:.3f} GiB")
        check(summary.trace.shape == (c.duration_s, c.params.n_hubs),
              f"{name}: trace shape {summary.trace.shape}")
    return launches


# ---------------------------------------------------------------- phase 8

def _load(dev, tag, kill, kill_at=6, **kw):
    """One run_service_load with the schedule `kw`, killed at tick
    `kill_at` and warm-restarted from its checkpoint when `kill`."""
    from dst_libp2p_test_node_tpu_torch.runtime.traffic import (
        run_service_load)

    os.makedirs(SCRATCH, exist_ok=True)
    ck = os.path.join(SCRATCH, f"{tag}_svc.npz")
    extra = (dict(kill_at_tick=kill_at, checkpoint_path=ck,
                  checkpoint_every=2) if kill else {})
    out = run_service_load(**kw, **extra, device=dev)
    json.dumps(out, allow_nan=False)          # the report is strict JSON
    return out


def phase_service_parity(dev):
    """8(a): run_service_load at 64 peers over HTTP, batched and killed at
    tick 6, on the card and on the CPU: the same records sha, both
    lineages bit-identical, and a sequential run's sha the same."""
    t0 = time.time()
    gpu = _load(dev, "svc_gpu", True, **SVC_PARITY)
    cpu = _load(torch.device("cpu"), "svc_cpu", True, **SVC_PARITY)
    seq = _load(dev, "svc_seq", False, **SVC_PARITY,
                dispatch_mode="sequential")
    for name, r in (("CUDA", gpu), ("CPU", cpu)):
        check(r["kill"]["bit_identical"],
              f"8(a) {name}: the restarted lineage's records differ")
    check(gpu["records_sha"] == cpu["records_sha"],
          "8(a): CUDA and CPU records differ")
    check(seq["records_sha"] == gpu["records_sha"],
          "8(a): sequential dispatch gave other records than batched")
    print(f"[service] 8(a) {SVC_PARITY['n_peers']} peers x "
          f"{gpu['config']['topics']} topics, HTTP, batched, killed at tick "
          f"6 and restarted at tick {gpu['kill']['resume_tick']}: records "
          f"sha {gpu['records_sha'][:16]} on CUDA = CPU = sequential; "
          f"bit_identical on both; {gpu['dispatched']} dispatched, shed "
          f"rate {gpu['shed_rate']:.4f} ({time.time() - t0:.1f} s)")


def _service_line(tag, r, launches, peak):
    w = r["walls"]
    lin = w["lineages"]
    ref = lin.get("reference") or lin["run"]
    rps = ref["dispatched"] / ref["drive_s"]
    classes = "; ".join(
        f"{k} {v['messages']} msgs p50 {v['p50_ms']:.3f} p99 "
        f"{v['p99_ms']:.3f} ms coverage {v['coverage']:.6f}"
        for k, v in sorted(r["classes"].items()))
    walls = "; ".join(
        (f"{k}: set-up {v['build_s']:.3f} s, warm-up {v['warmup_s']:.3f} s, "
         if "build_s" in v else f"{k}: ")
        + f"drive {v['drive_s']:.3f} s, of it publishing {v['publish_s']:.3f}"
        f" s for {v['dispatched']} publishes"
        for k, v in lin.items())
    ck = ""
    if "checkpoint_bytes" in w:
        ck = (f"; checkpoint {w['checkpoint_bytes'] / 2**20:.1f} MiB, saves "
              f"{', '.join(f'{x:.3f}' for x in w['checkpoint_save_s'])} s, "
              f"load {w['checkpoint_load_s']:.3f} s")
    print(f"[service] 8(b) {tag}: {walls}{ck}")
    print(f"[service] 8(b) {tag}: {rps:.3f} requests/s (uninterrupted "
          f"lineage, {ref['dispatched']} publishes / {ref['drive_s']:.3f} s "
          f"of drive), requests_per_s {r['requests_per_s']}; sojourn p50 "
          f"{r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms; shed rate "
          f"{r['shed_rate']:.4f} ({r['rejected']} of {r['offered']} "
          f"rejected, {r['shed_deadline']} past deadline); max depth "
          f"{r['max_depth_seen']} of {SVC_LOAD['max_queue_depth']}; "
          f"{r['device_dispatches']} device dispatches; launches {launches}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"[service] 8(b) {tag}: dissemination by class: {classes}")
    return rps


def phase_service(dev):
    """8(b): the ETH2 mainnet topic mix (67 topics) at 10,000 peers (670k
    stacked rows x 40 slots) through run_service_load over HTTP, 5 ticks
    of 1 s at 2x overload, batched and killed at tick 2, then the same
    schedule sequential. Counts zeroed at the start of each run."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg

    out = {}
    for tag, kill, mode in (("batched", True, "batched"),
                            ("sequential", False, "sequential")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vg.launches = 0
        su.launches = 0
        t0 = time.time()
        r = _load(dev, f"svc_{tag}", kill, kill_at=SVC_KILL_TICK,
                  **SVC_LOAD, dispatch_mode=mode)
        wall = time.time() - t0
        launches = {"vmem_gather": vg.launches, "score_update": su.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        check(r["config"]["topics"] == 3 + SVC_SUBNETS,
              f"8(b) ran {r['config']['topics']} topics")
        check(r["queue_bound_held"], f"8(b) {tag}: the queue bound broke")
        check(0.0 < r["shed_rate"] < 1.0,
              f"8(b) {tag}: shed rate {r['shed_rate']} not in (0, 1)")
        for name, count in launches.items():
            check(count > 0, f"8(b) {tag} never launched {name}")
        rps = _service_line(f"{tag} ({wall:.1f} s)", r, launches, peak)
        out[tag] = dict(report=r, launches=launches, rps=rps, wall=wall)
    b = out["batched"]["report"]
    check(b["kill"]["bit_identical"],
          "8(b): the restarted lineage's records differ")
    check(out["sequential"]["report"]["records_sha"] == b["records_sha"],
          "8(b): sequential dispatch gave other records than batched")
    print(f"[service] 8(b) bit_identical across the kill (resumed at tick "
          f"{b['kill']['resume_tick']}); batched sha = sequential sha "
          f"{b['records_sha'][:16]}")
    return out


def _http(port, path, data=None, timeout=30):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _spawn_serve(args, log, env):
    """`python -m dst_libp2p_test_node_tpu_torch serve` with its output in
    `log`; returns (process, log, spawn time) for _serve_up."""
    t0 = time.time()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dst_libp2p_test_node_tpu_torch", "serve",
             "--control-port", "0", "--metrics-port", "0", *args],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, log, t0


def _start_serve(args, log, env):
    """_spawn_serve, then _serve_up."""
    return _serve_up(*_spawn_serve(args, log, env))


def _serve_up(proc, log, t0):
    """Waits for a spawned serve's line with its ports, then for /ready.
    Returns (process, control port, metrics port, s from spawn)."""
    import re

    ports = None
    while time.time() - t0 < 300:
        if proc.poll() is not None:
            break
        with open(log) as f:
            m = re.search(r"serving control :(\d+) metrics :(\d+)", f.read())
        if m:
            ports = int(m.group(1)), int(m.group(2))
            break
        time.sleep(0.2)
    if ports is None:
        proc.kill()
        with open(log) as f:
            tail = f.read()[-2000:]
        raise SmokeFailure(f"serve did not come up: {tail}")
    check(_http(ports[0], "/ready") == (200, "ok"), "/ready did not say ok")
    return proc, ports[0], ports[1], time.time() - t0


def _inject(port, messages, burst):
    """The `inject` command in this process; (stdout, rc, wall s)."""
    from dst_libp2p_test_node_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["inject", f"127.0.0.1:{port}", "-s", "15000", "-m",
                       str(messages), "-d", "0", "--burst", str(burst)])
    return buf.getvalue(), rc, time.time() - t0


def _dispatched(port, want, timeout=120):
    """Seconds until GET /service counts `want` dispatched requests, and
    the status once that pump round has ended (its dispatch estimate
    updated)."""
    t0 = time.time()
    seen = None
    while time.time() - t0 < timeout:
        status = json.loads(_http(port, "/service")[1])
        if seen is None and status["counters"]["dispatched"] >= want:
            seen = time.time() - t0, status["pump_rounds"]
        if seen is not None and status["pump_rounds"] > seen[1]:
            return seen[0], status
        time.sleep(0.05)
    raise SmokeFailure(f"the service dispatched fewer than {want} in "
                       f"{timeout} s")


def _stop_serve(proc, what):
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise SmokeFailure(f"{what}: SIGTERM did not end serve")
    check(rc == 0, f"{what}: serve exited {rc} after SIGTERM")


SERVE_CK = os.path.join(SCRATCH, "serve_ck.npz")


def serve8c_start():
    """8(c)'s first `serve` process, spawned early (beside 8(a)); returns
    _spawn_serve's handle for phase_serve."""
    os.makedirs(SCRATCH, exist_ok=True)
    return _spawn_serve([*SERVE_FLAGS, "--checkpoint", SERVE_CK],
                        os.path.join(SCRATCH, "serve1.log"),
                        dict(os.environ, **SERVE_ENV))


def phase_serve(dev, first):
    """8(c): the `serve` process at config 4's width (100,000 peers, 4
    fragments, a 60 s warm-up) with a checkpoint, spawned beside 8(a)
    (`first`, serve8c_start's handle): /health and /ready, `inject` of 3
    x 15,000 B in one burst, the three families on /metrics, SIGTERM
    (drain, final checkpoint, exit 0), then `serve --resume` from that
    checkpoint answers /health and one more inject."""
    ck = SERVE_CK
    env = dict(os.environ, **SERVE_ENV)
    procs = [first[0]]
    try:
        proc, cport, mport, up_s = _serve_up(*first)
        check(_http(cport, "/health") == (200, "ok"), "/health != ok")
        text, rc, inj_s = _inject(cport, 3, 3)
        check(rc == 0 and "published ok=3 failed=0" in text,
              f"inject: {text}")
        disp_s, status = _dispatched(cport, 3)
        metrics = _http(mport, "/metrics")[1]
        for fam in ("dst_testnode_", "libp2p_", "dst_service_"):
            check(f"\n{fam}" in metrics, f"/metrics has no {fam}* family")
        _stop_serve(proc, "serve")
        check(os.path.exists(ck), "serve left no final checkpoint")
        print(f"[serve] 8(c) PEERS={EXACT_N} FRAGMENTS=4 serve --warmup-s 60 "
              f"--checkpoint: process start to /ready {up_s:.3f} s (started "
              f"beside 8(a)); inject "
              f"3 x 15,000 B --burst 3: 3 replies of 200 in {inj_s:.3f} s, "
              f"all dispatched {disp_s:.3f} s later "
              f"({status['counters']['device_dispatches']} device "
              f"dispatches, est. {status['est_dispatch_ms']} ms a request); "
              f"/metrics carries dst_testnode_*, libp2p_*, dst_service_*; "
              f"SIGTERM: exit 0, checkpoint "
              f"{os.path.getsize(ck) / 2**20:.1f} MiB")
        proc, cport, mport, up_s = _start_serve(
            [*SERVE_FLAGS, "--checkpoint", ck, "--resume"],
            os.path.join(SCRATCH, "serve2.log"), env)
        procs.append(proc)
        check(_http(cport, "/health") == (200, "ok"), "resumed /health")
        text, rc, inj_s = _inject(cport, 1, 1)
        check(rc == 0 and "published ok=1 failed=0" in text,
              f"resumed inject: {text}")
        disp_s, status = _dispatched(cport, 4)
        check(status["counters"]["restarts"] == 1,
              f"resumed service counts {status['counters']['restarts']} "
              f"restarts")
        _stop_serve(proc, "resumed serve")
        print(f"[serve] 8(c) serve --resume: process start to /ready "
              f"{up_s:.3f} s; one more inject: 200 in {inj_s:.3f} s, "
              f"dispatched {disp_s:.3f} s later; restarts 1; SIGTERM exit 0")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_8(dev):
    t0 = time.time()
    first = serve8c_start()         # 8(c)'s first serve, beside 8(a)
    try:
        phase_service_parity(dev)
    except BaseException:
        first[0].kill()
        first[0].wait()
        raise
    phase_serve(dev, first)         # before 8(b): the serve is up by now
    out = phase_service(dev)
    print(f"[service] phase 8 took {time.time() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 9

CAMP_PARITY_N = 128
# BASELINE config 6 (bench_configs.config_6): the reference's campaign row
CAMP6_N = 2048
# 9(c): a campaign on config 4's network (bench_configs.config_4 through
# _run_simple: 100k peers, 4 fragments of 15,000 B, 3 messages 2 s apart,
# a 60 s warm-up; the campaign path has no churn knob)
CAMP_FULL_N = EXACT_N
# 10(b)'s seeds: seed 0 alone since phase 13 joined the smoke (seeds 0 and
# 1 before: 2 trials a campaign, 4 before; PERF.md section 4 lists the cut)
CAMP10_SEEDS = (0,)


def _campaign_cfg(n, scenario, fractions, seeds, attack_hb, warmup_s,
                  msg_size=2000, frags=1, recovery=0, ckpt=None,
                  anchor_stages=5, telemetry=True):
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams
    from dst_libp2p_test_node_tpu_torch.ops.telemetry import (
        TelemetryParams)
    from dst_libp2p_test_node_tpu_torch.runtime import campaign as camp
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    repair = (RepairParams(evict=True, px=True, redial=True) if recovery
              else RepairParams())
    return camp.CampaignConfig(
        scenario=scenario, fractions=fractions, seeds=seeds,
        experiment=ExperimentConfig(
            topo=TopoParams(
                network_size=n, anchor_stages=anchor_stages,
                min_bandwidth=50, max_bandwidth=150, min_latency=40,
                max_latency=130, msg_size_bytes=msg_size, num_frags=frags,
                messages=3, delay_seconds=2.0),
            connect_to=10, warmup_s=warmup_s, seed=0,
            gossipsub=camp.attack_gossipsub(
                flood_publish=scenario != "eclipse_publisher")),
        attack_heartbeats=attack_hb, recovery_heartbeats=recovery,
        repair=repair, telemetry=TelemetryParams(record=telemetry),
        checkpoint_dir=ckpt)


def _campaign_fields(res):
    from dst_libp2p_test_node_tpu_torch import interop

    return interop.result_fields(res, walls=False)


def _same_npz_dirs(what, a, b):
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)) and names,
          f"{what}: checkpoint files differ: {names}")
    for name in names:
        with np.load(os.path.join(a, name)) as za, \
                np.load(os.path.join(b, name)) as zb:
            check(za.files == zb.files, f"{what}: {name} keys differ")
            for k in za.files:
                check(za[k].dtype == zb[k].dtype
                      and za[k].tobytes() == zb[k].tobytes(),
                      f"{what}: {name}[{k}] differs")


def _windows_both(dev, cfg):
    """One warm Simulator per device; the attack window, the recovery
    window, rebind_graph and one censored publish on each: states, graphs,
    curves and records bitwise."""
    from dst_libp2p_test_node_tpu_torch import interop
    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops.repair import (
        run_recovery_heartbeats)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    adv = cfg.adversary_params()
    out = []
    for d in (dev, torch.device("cpu")):
        sim = Simulator(cfg.experiment, device=d)
        sim.warmup()
        att_np = adv_ops.attacker_cohort(
            sim.params.n, 0.2, 0, conns=sim.graph.conns, publisher=4,
            eclipse=adv.eclipse)
        att = torch.as_tensor(att_np, device=d)
        a = sim.arrays
        if adv.eclipse:
            sim.state = adv_ops.eclipse_setup(sim.state, a["conns"], att, 4)
        st, obs1 = adv_ops.run_attacked_heartbeats(
            sim.state, a["conns"], a["rev"], a["out_mask"], att, sim.params,
            adv, cfg.attack_heartbeats, telemetry=cfg.telemetry)
        (st, cn, rv, om), obs2 = run_recovery_heartbeats(
            st, a["conns"], a["rev"], a["out_mask"], att,
            cfg.repair.apply(sim.params), cfg.recovery_heartbeats,
            publisher=4, telemetry=cfg.telemetry)
        sim.state = st
        sim.rebind_graph(cn, rv, om)
        rec = sim.publish(4, censor_edge=adv_ops.censor_mask(att, cn))
        out.append(dict(
            state=interop.state_to_numpy(sim.state),
            graph={k: v.cpu().numpy() for k, v in sim.arrays.items()},
            obs={**{f"attack/{k}": v for k, v in
                    interop.obs_to_numpy(obs1).items()},
                 **{f"recovery/{k}": v for k, v in
                    interop.obs_to_numpy(obs2).items()}},
            record={k: getattr(rec, k) for k in ("delays_ms", "received",
                                                  "sends", "copies_rx")}))
    g, c = out
    for part in ("state", "graph", "obs", "record"):
        bad = [k for k in c[part]
               if not np.array_equal(c[part][k], g[part][k])
               or c[part][k].dtype != g[part][k].dtype
               or c[part][k].tobytes() != g[part][k].tobytes()]
        check(not bad, f"9(a) {cfg.scenario} windows: {part} {bad} differ")
    return int(g["state"]["redials"].sum()), int(g["state"]["evictions"]
                                                   .sum())


def phase_campaign_parity(dev):
    """9(a): every static scenario's campaign (128 peers, fractions 0 and
    0.2, seeds 0 and 1, flight recorder and trial checkpoints on) on the
    card and on the CPU: TrialResult fields, checkpoint states and obs
    sidecars bitwise; graft flood and eclipse again with a recovery window
    (evict + px + redial), and their windows, rebind and one censored
    publish compared leaf by leaf."""
    from dst_libp2p_test_node_tpu_torch.ops.adversary import SCENARIOS
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    t0 = time.time()
    cases = [(s, 0) for s in SCENARIOS] + [("sybil_graft_flood", 8),
                                           ("eclipse_publisher", 8)]
    summary = []
    for scenario, recovery in cases:
        res = []
        for i, d in enumerate((dev, torch.device("cpu"))):
            ck = os.path.join(SCRATCH, f"camp9a_{scenario}_{recovery}_{i}")
            shutil.rmtree(ck, ignore_errors=True)
            cfg = _campaign_cfg(CAMP_PARITY_N, scenario, (0.0, 0.2), (0, 1),
                                6, 5.0, recovery=recovery, ckpt=ck,
                                anchor_stages=3)
            res.append((run_campaign(cfg, device=d), ck))
        (rg, ckg), (rc, ckc) = res
        check(_campaign_fields(rg) == _campaign_fields(rc),
              f"9(a) {scenario} (recovery {recovery}): TrialResults differ")
        _same_npz_dirs(f"9(a) {scenario}", ckg, ckc)
        att = [t for t in rg.trials if t.fraction > 0]
        tag = f"{scenario}{'+recovery' if recovery else ''}"
        if recovery:
            redials, evictions = _windows_both(dev, cfg)
            check(redials > 0, f"9(a) {tag}: no dial committed")
            tag += f" (windows: {redials} redials, {evictions} evictions)"
        summary.append(f"{tag}: coverage "
                       f"{min(t.honest_coverage for t in att):.4f}")
    print(f"[campaign] 9(a) {len(cases)} campaigns at {CAMP_PARITY_N} peers "
          f"x 2 fractions x 2 seeds: CUDA = CPU in every TrialResult field, "
          f"checkpoint state and obs curve ({time.time() - t0:.1f} s); "
          + "; ".join(summary))


def _trial_line(t):
    return (f"f={t['fraction']:g} s={t['seed']}: coverage "
            f"{t['honest_coverage']:.4f}, p50 {t['latency_p50_ms']} ms, p99 "
            f"{t['latency_p99_ms']} ms, hb_to_graylist {t['hb_to_graylist']}"
            f" (budget {t['hb_budget']}), mesh_recovery_hb "
            f"{t['mesh_recovery_hb']}, recovery_time_ms "
            f"{t['recovery_time_ms']}, evictions "
            f"{t['mesh_evictions_total']}, px_grafts {t['px_grafts_total']}"
            f", redials {t['redials_total']}, attacker_score "
            f"{t['attacker_score_final']:.3f}")


def _worst(d):
    att = [t for t in d["trials"] if t["fraction"] > 0]
    return (f"worst attacked coverage "
            f"{min(t['honest_coverage'] for t in att):.4f}, p50 "
            f"{max(t['latency_p50_ms'] or math.inf for t in att)} ms, p99 "
            f"{max(t['latency_p99_ms'] or math.inf for t in att)} ms, "
            f"hb_to_graylist {[t['hb_to_graylist'] for t in att]} against "
            f"hb_budget {d['hb_budget']}")


def _strip_walls(d):
    d = dict(d, trials=[{k: v for k, v in t.items() if k != "wall_s"}
                        for t in d["trials"]])
    d.pop("wall_s")
    d.pop("trials_per_s")
    return d


CAMP6_JSON = os.path.join(SCRATCH, "camp6.json")
CAMP6_PROM = os.path.join(SCRATCH, "camp6.prom")


def attack9b_start():
    """9(b)'s `attack` process, started early (side_start)."""
    side_start("attack9b", port_cmd(
        "attack", "-n", str(CAMP6_N), "--msg-size", "2000", "--connect-to",
        "10", "--warmup-s", "30", "--fractions", "0,0.1", "--seeds", "0,1",
        "--attack-heartbeats", "20", "--messages", "3", "--delay-s", "2",
        "--json", CAMP6_JSON, "--metrics-out", CAMP6_PROM))


def phase_config6(dev):
    """9(b): BASELINE config 6 as bench_configs.config_6 defines it (2048
    peers, 2,000 B, connect_to 10, 30 s warm-up, attack_gossipsub(),
    sybil_graft_flood, fractions 0 and 0.1, seeds 0 and 1, 20 attack
    heartbeats) through run_campaign; then the `attack` CLI in a process
    at that width and grid (the CLI's topology: 3 anchor stages, 50 Mbps,
    100 ms) with --json and --metrics-out, its JSON equal to an in-process
    run_campaign of the same config."""
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        CampaignConfig, run_campaign)

    t0 = time.time()
    base = _campaign_cfg(CAMP6_N, "sybil_graft_flood", (0.0, 0.1), (0, 1),
                         20, 30.0, telemetry=False)
    cfg6 = CampaignConfig(scenario="sybil_graft_flood",
                          fractions=(0.0, 0.1), seeds=(0, 1),
                          experiment=base.experiment, attack_heartbeats=20)
    res = run_campaign(cfg6, device=dev)
    d6 = res.to_dict()
    print(f"[campaign] 9(b) config 6 ({CAMP6_N} peers): wall_s "
          f"{res.wall_s:.3f}, trials_per_s {res.trials_per_s:.4f}; "
          f"{_worst(d6)}")
    for t in d6["trials"]:
        print(f"[campaign] 9(b)   {_trial_line(t)}")
    check(all(t["hb_to_graylist"] > 0 for t in d6["trials"]
              if t["fraction"] > 0), "9(b): the graylist never engaged")
    proc, cli_s = side_wait("attack9b")
    check(proc.returncode == 0, f"attack CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(CAMP6_JSON) as f:
        d_cli = json.load(f)
    with open(CAMP6_PROM) as f:
        text = f.read()
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        attack_gossipsub)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    cli_cfg = CampaignConfig(
        scenario="sybil_graft_flood", fractions=(0.0, 0.1), seeds=(0, 1),
        experiment=ExperimentConfig(
            topo=TopoParams(network_size=CAMP6_N, anchor_stages=3,
                            msg_size_bytes=2000, messages=3,
                            delay_seconds=2.0),
            connect_to=10, gossipsub=attack_gossipsub(), publisher_id=4,
            warmup_s=30.0, seed=0),
        attack_heartbeats=20)
    d_in = run_campaign(cli_cfg, device=dev).to_dict()
    check(_strip_walls(d_cli) == _strip_walls(d_in),
          "9(b): the attack CLI's JSON differs from run_campaign's")
    check("dst_testnode_attack_honest_coverage{" in text,
          "9(b): --metrics-out has no attack series")
    print(f"[campaign] 9(b) attack CLI ({CAMP6_N} peers, a process run "
          f"beside 9(a)): exit 0 in {cli_s:.1f} s, JSON = in-process "
          f"run_campaign outside the "
          f"walls (CLI wall_s {d_cli['wall_s']:.3f}, trials_per_s "
          f"{d_cli['trials_per_s']:.4f}); {_worst(d_cli)}; metrics "
          f"{len(text.splitlines())} lines ({time.time() - t0:.1f} s)")


def _window_syncs(dev, cfg):
    """Host syncs (aten::_local_scalar_dense) of one attack window and one
    recovery window at the campaign's shape, under the CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops.repair import (
        run_recovery_heartbeats)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    sim = Simulator(cfg.experiment, device=dev)
    sim.warmup()
    att = torch.as_tensor(adv_ops.attacker_cohort(
        sim.params.n, 0.1, 0, publisher=4), device=dev)
    a = sim.arrays
    out = {}
    st = sim.state
    for name in ("attack", "recovery"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.time()
            if name == "attack":
                st, _ = adv_ops.run_attacked_heartbeats(
                    st, a["conns"], a["rev"], a["out_mask"], att, sim.params,
                    cfg.adversary_params(), cfg.attack_heartbeats,
                    telemetry=cfg.telemetry)
            else:
                run_recovery_heartbeats(
                    st, a["conns"], a["rev"], a["out_mask"], att,
                    cfg.repair.apply(sim.params), cfg.recovery_heartbeats,
                    publisher=4, telemetry=cfg.telemetry)
            torch.cuda.synchronize()
            wall = time.time() - t0
        syncs = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::_local_scalar_dense")
        out[name] = (syncs, wall)
    return out


def phase_campaign_full(dev):
    """9(c): a campaign on config 4's network, 100,000 peers x 4 fragments
    of 15,000 B (exact mode, no churn): sybil_graft_flood,
    attack_gossipsub(), fractions 0 and 0.1, seeds 0 and 1, 20 attack
    heartbeats, then 10 recovery heartbeats (evict + px + redial, so
    rebind_graph runs at 100k), flight recorder and checkpoints on. Counts
    zeroed just before and read just after. A second run_campaign on the
    same directory resumes every attacked trial and gives the same result
    outside the walls. Returns the first run's launches, its result and
    its peak allocated memory (phases 14(b) and 16(b) hold the grid and
    the mesh against them)."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    ck = os.path.join(SCRATCH, "camp9c")
    shutil.rmtree(ck, ignore_errors=True)
    cfg = _campaign_cfg(CAMP_FULL_N, "sybil_graft_flood", (0.0, 0.1),
                        (0, 1), 20, EXACT_WARMUP_S, msg_size=15000, frags=4,
                        recovery=10, ckpt=ck)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    res = run_campaign(cfg, device=dev)
    torch.cuda.synchronize()
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    d = res.to_dict()
    print(f"[campaign] 9(c) {CAMP_FULL_N} peers x 4 fragments, "
          f"sybil_graft_flood, fractions 0/0.1 x seeds 0/1, 20 attack + 10 "
          f"recovery heartbeats, telemetry and checkpoints on: wall_s "
          f"{res.wall_s:.3f}, trials_per_s {res.trials_per_s:.4f}; "
          f"launches {launches}; peak memory {peak / 2**30:.2f} GiB; "
          f"{_worst(d)}")
    for t, w in zip(d["trials"], res.phase_walls):
        walls = ", ".join(f"{k} {v:.3f} s" for k, v in w.items()
                          if k not in ("fraction", "seed", "resumed"))
        print(f"[campaign] 9(c)   {_trial_line(t)}; walls: {walls}")
    for name, count in launches.items():
        check(count > 0, f"9(c): the campaign never launched {name}")
    att = [t for t in res.trials if t.fraction > 0]
    check(all(t.redials_total > 0 for t in att), "9(c): no dial committed")
    for t in res.trials:
        check(math.isfinite(t.honest_coverage) and t.honest_coverage > 0,
              f"9(c): trial {t.fraction}/{t.seed} delivered nothing")
    t1 = time.time()
    again = run_campaign(cfg, device=dev)
    resumed = [w for w in again.phase_walls if w["fraction"] > 0]
    check(resumed and all(w["resumed"] for w in resumed),
          "9(c): the second run did not resume every attacked trial")
    check(_campaign_fields(again) == _campaign_fields(res),
          "9(c): the resumed campaign differs from the first run")
    print(f"[campaign] 9(c) resumed from {len(os.listdir(ck))} checkpoint "
          f"files: same CampaignResult outside the walls "
          f"({time.time() - t1:.1f} s, wall_s {again.wall_s:.3f})")
    syncs = _window_syncs(dev, cfg)
    print(f"[campaign] 9(c) host syncs: attack window "
          f"{syncs['attack'][0]} in {cfg.attack_heartbeats} heartbeats "
          f"({syncs['attack'][1]:.3f} s profiled), recovery window "
          f"{syncs['recovery'][0]} in {cfg.recovery_heartbeats} "
          f"({syncs['recovery'][1]:.3f} s profiled)")
    return launches, res, peak


def phase_service_telemetry(dev):
    """9(d): the service's flight recorder at phase 8(b)'s width (10,000
    peers, connect_to 10, one topic: the reference records single-topic
    simulators only): record_telemetry, one pump tick, then GET /telemetry
    and /metrics over HTTP."""
    from dst_libp2p_test_node_tpu_torch.config.env import NodeConfig
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.ops.telemetry import (
        TelemetryParams)
    from dst_libp2p_test_node_tpu_torch.runtime import node_service as ns
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    t0 = time.time()
    sim = Simulator(ExperimentConfig(
        topo=TopoParams(network_size=SVC_N, msg_size_bytes=1500),
        connect_to=10, warmup_s=10.0), device=dev)
    sim.warmup()
    svc = ns.NodeService(sim, NodeConfig(my_id=2, network_size=SVC_N,
                                         connect_to=10),
                         control_port=0, metrics_port=0,
                         service=ns.ServiceConfig())
    sim.record_telemetry(TelemetryParams(record=True))
    svc.pump(advance_ms=1000.0)
    svc.start()
    try:
        body = json.loads(_http(svc.control_port, "/telemetry")[1])
        metrics = _http(svc.metrics_port, "/metrics")[1]
    finally:
        svc.stop()
    curves = body["curves"]
    check(body["armed"] is True, "9(d): /telemetry is not armed")
    check(curves and all(len(v) == 1 for v in curves.values())
          and set(curves) >= {"tel_mesh_coverage", "tel_score_q"},
          f"9(d): /telemetry curves {sorted(curves)}")
    check("dst_sim_round_mesh_coverage{" in metrics,
          "9(d): /metrics has no dst_sim_round_* series")
    print(f"[campaign] 9(d) service at {SVC_N} peers, recorder armed, one "
          f"tick: /telemetry armed {body['armed']}, {len(curves)} tel_* "
          f"curves of {body['heartbeats']} heartbeat (mesh coverage "
          f"{curves['tel_mesh_coverage'][0]:.4f}, score quantiles "
          f"{curves['tel_score_q'][0]}); /metrics carries dst_sim_round_* "
          f"({time.time() - t0:.1f} s)")


def phase_9(dev):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    # beside 9(a): 12(d)'s trace, 9(b)'s attack process, 15(d)'s script
    trace12d_start(dev)
    attack9b_start()
    dcn15d_start()
    with shared_cores():
        phase_campaign_parity(dev)
    for name in ("trace12d", "attack9b", "dcn15d"):
        side_wait(name)
    phase_config6(dev)
    launches, res9c, peak9c = phase_campaign_full(dev)
    phase_service_telemetry(dev)
    print(f"[campaign] phase 9 took {time.time() - t0:.1f} s")
    return launches, res9c, peak9c


# ---------------------------------------------------------------- phase 10

CAMP10_N = CAMP6_N
# 10(b)'s fault schedule: crash, partition and spike windows overlapping
# inside the 20-round attack window
FAULTS10 = dict(crash_frac=0.05, crash_window=(2, 8), partition_frac=0.5,
                partition_window=(4, 12), spike_frac=0.05,
                spike_window=(0, 6), spike_ms=500.0)


def _cfg10(n, scenario, fractions, seeds, attack_hb, warmup_s, faults=None,
           adaptive=False, dht=None, **kw):
    """_campaign_cfg with the slice-10 knobs: a fault schedule, the
    adaptive attacker (its defaults), the DHT adversary."""
    from dst_libp2p_test_node_tpu_torch.ops.adversary import (
        AdaptivePolicy, AdversaryParams)
    from dst_libp2p_test_node_tpu_torch.ops.dht_adversary import (
        DhtAdversaryParams)
    from dst_libp2p_test_node_tpu_torch.ops.faults import FaultParams

    cfg = _campaign_cfg(n, scenario, fractions, seeds, attack_hb, warmup_s,
                        **kw)
    return dataclasses.replace(
        cfg, faults=FaultParams(**(faults or {})),
        dht=DhtAdversaryParams(**(dht or {})),
        adversary=AdversaryParams(scenario=scenario,
                                  adaptive=AdaptivePolicy(enabled=adaptive)))


def _both_devices(dev, tag, make_cfg, run):
    """run(cfg, device) on the card and on the CPU with a checkpoint
    directory each; CampaignResult fields and checkpoint files bitwise."""
    res = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        ck = os.path.join(SCRATCH, f"camp10a_{tag}_{i}")
        shutil.rmtree(ck, ignore_errors=True)
        res.append((run(make_cfg(ck), d), ck))
    (rg, ckg), (rc, ckc) = res
    check(_campaign_fields(rg) == _campaign_fields(rc),
          f"10(a) {tag}: TrialResults differ")
    _same_npz_dirs(f"10(a) {tag}", ckg, ckc)
    return rg


def phase_campaign10_parity(dev):
    """10(a): at 128 peers (fractions 0 and 0.2, seeds 0 and 1), on the
    card and on the CPU: each fault family alone and the three composed
    (graft flood; the composed partition still open over the publishes),
    the adaptive attacker on eclipse and graft flood with a recovery
    window (evict + px + redial, slot race), the DHT two-leg campaign
    (eclipse + poison + cluster, healing at recovery round 3), all with
    checkpoints and the recorder: fields, checkpoint states, kad leaves
    and obs sidecars bitwise; then a run_defense_sweep of 2 bands x 2
    weights, its artifact equal outside wall_s."""
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        run_campaign, run_defense_sweep)

    t0 = time.time()
    n = CAMP_PARITY_N
    common = dict(fractions=(0.0, 0.2), seeds=(0, 1), attack_hb=10,
                  warmup_s=5.0, anchor_stages=3)
    cases = {
        "crash": dict(scenario="sybil_graft_flood", faults=dict(
            crash_frac=0.1, crash_window=(2, 6))),
        "partition": dict(scenario="sybil_graft_flood", faults=dict(
            partition_frac=0.5, partition_window=(2, 6))),
        "spike": dict(scenario="sybil_graft_flood", faults=dict(
            spike_frac=0.1, spike_window=(0, 6), spike_ms=500.0)),
        "composed": dict(scenario="sybil_graft_flood", faults=dict(
            FAULTS10, crash_frac=0.1, partition_window=(4, 40))),
        "adaptive_eclipse": dict(scenario="eclipse_publisher",
                                 adaptive=True, recovery=8),
        "adaptive_flood": dict(scenario="sybil_graft_flood", adaptive=True,
                               recovery=8),
        "dht": dict(scenario="eclipse_publisher", recovery=8, dht=dict(
            lookup_eclipse=True, rtable_poison=True, sybil_cluster=True,
            heal_hb=3)),
    }
    summary = []
    attacked = {}
    for tag, kw in cases.items():
        rg = _both_devices(
            dev, tag, lambda ck, kw=kw: _cfg10(n, ckpt=ck, **common, **kw),
            lambda c, d: run_campaign(c, device=d))
        attacked[tag] = [t for t in rg.trials if t.fraction > 0]
        summary.append(f"{tag}: coverage "
                       f"{min(t.honest_coverage for t in attacked[tag]):.4f}")
    check(all(0 < t.rtable_poison_frac < 1 for t in attacked["dht"]),
          "10(a) dht: no routing-table poison measured")
    sweep = []
    for d in (dev, torch.device("cpu")):
        cfg = _cfg10(n, "eclipse_publisher", (0.2,), (0, 1), 6, 5.0,
                     adaptive=True, recovery=6, anchor_stages=3,
                     telemetry=False)
        sw = run_defense_sweep(cfg, degree_grid=((4, 6, 8), (6, 8, 12)),
                               weight_grid=(-10.0, -20.0), device=d)
        sw.pop("wall_s")
        sweep.append(sw)
    check(sweep[0] == sweep[1], "10(a): the defense sweep differs")
    check(len(sweep[0]["configs"]) == 4 and sweep[0]["pareto"],
          f"10(a): sweep front {sweep[0]['pareto']}")
    print(f"[campaign10] 10(a) {len(cases)} campaigns at {n} peers x 2 "
          f"fractions x 2 seeds and a 2 x 2 defense sweep: CUDA = CPU in "
          f"every TrialResult field, checkpoint file and sweep row "
          f"({time.time() - t0:.1f} s); " + "; ".join(summary)
          + f"; sweep front {sweep[0]['pareto']}, beats default "
          f"{sweep[0]['beats_default']}")


def _resilience(t):
    return (f"heal_time_ms {t['heal_time_ms']}, post_churn_reconvergence_hb"
            f" {t['post_churn_reconvergence_hb']}, coverage_under_partition "
            f"{t['coverage_under_partition']}, rtable_poison_frac "
            f"{t['rtable_poison_frac']}")


def _window10_syncs(dev, cfg):
    """Host syncs (aten::_local_scalar_dense) and profiled wall of one
    faulted (10(b)'s schedule, graft flood) and one adaptive (eclipse)
    attack window at the campaign's shape, under the CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops import faults as fault_ops
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    sim = Simulator(cfg.experiment, device=dev)
    sim.warmup()
    n = sim.params.n
    att = torch.as_tensor(adv_ops.attacker_cohort(n, 0.1, 0, publisher=4),
                          device=dev)
    fp = fault_ops.FaultParams(**FAULTS10)
    fm = {k: torch.as_tensor(v, device=dev) for k, v in
          fault_ops.fault_masks(n, fp, 0, publisher=4).items()}
    a = sim.arrays
    out = {}
    for name in ("faulted", "adaptive"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.time()
            if name == "faulted":
                fault_ops.run_faulted_heartbeats(
                    sim.state, a["conns"], a["rev"], a["out_mask"], att,
                    sim.params, adv_ops.AdversaryParams(), fp, fm["crash"],
                    fm["side"], fm["spike"], cfg.attack_heartbeats,
                    telemetry=cfg.telemetry)
            else:
                adv_ops.run_adaptive_heartbeats(
                    sim.state, a["conns"], a["rev"], a["out_mask"], att,
                    sim.params, adv_ops.AdversaryParams(
                        scenario="eclipse_publisher",
                        adaptive=adv_ops.AdaptivePolicy(enabled=True)),
                    cfg.attack_heartbeats, telemetry=cfg.telemetry)
            torch.cuda.synchronize()
            wall = time.time() - t0
        out[name] = (sum(e.count for e in prof.key_averages()
                         if e.key == "aten::_local_scalar_dense"), wall)
    return out


def _campaign10_full(dev, tag, cfg):
    """One 10(b) campaign with its counts zeroed just before and read
    just after; prints its numbers and returns (launches, result)."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    res = run_campaign(cfg, device=dev)
    torch.cuda.synchronize()
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    d = res.to_dict()
    print(f"[campaign10] 10(b) {tag}: {CAMP_FULL_N} peers x 4 fragments, "
          f"{cfg.scenario}, fractions 0/0.1 x seeds {CAMP10_SEEDS}, "
          f"{cfg.attack_heartbeats} attack + {cfg.recovery_heartbeats} "
          f"recovery heartbeats: wall_s {res.wall_s:.3f}, trials_per_s "
          f"{res.trials_per_s:.4f}; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB; {_worst(d)}")
    for t, w in zip(d["trials"], res.phase_walls):
        walls = ", ".join(f"{k} {v:.3f} s" for k, v in w.items()
                          if k not in ("fraction", "seed", "resumed"))
        print(f"[campaign10] 10(b) {tag}   {_trial_line(t)}; "
              f"{_resilience(t)}; walls: {walls}")
    check(launches["vmem_gather"] > 0,
          f"10(b) {tag}: the campaign never launched vmem_gather")
    for t in res.trials:
        check(math.isfinite(t.honest_coverage) and t.honest_coverage > 0,
              f"10(b) {tag}: trial {t.fraction}/{t.seed} delivered nothing")
    return launches, res


def phase_campaign10_full(dev):
    """10(b): three campaigns on config 4's network (9(c)'s: 100,000 peers
    x 4 fragments of 15,000 B, exact, 60 s warm-up, no churn), each at
    fractions 0 / 0.1, seed 0 (CAMP10_SEEDS), 20 attack and 10 recovery
    heartbeats
    (evict + px + redial), checkpoints on: faults (graft flood under
    FAULTS10, recorder on), adaptive (eclipse, the default policy), dht
    (eclipse with lookup eclipse + rtable poison, healing at recovery
    round 5), the last rerun on its directory to the same result. Then
    the host syncs of one faulted and one adaptive window."""
    out = {}
    ck = {k: os.path.join(SCRATCH, f"camp10b_{k}")
          for k in ("faults", "adaptive", "dht")}
    for p in ck.values():
        shutil.rmtree(p, ignore_errors=True)
    common = dict(msg_size=15000, frags=4, recovery=10)
    cfgs = {
        "faults": _cfg10(CAMP_FULL_N, "sybil_graft_flood", (0.0, 0.1),
                         CAMP10_SEEDS, 20, EXACT_WARMUP_S, faults=FAULTS10,
                         ckpt=ck["faults"], **common),
        "adaptive": _cfg10(CAMP_FULL_N, "eclipse_publisher", (0.0, 0.1),
                           CAMP10_SEEDS, 20, EXACT_WARMUP_S, adaptive=True,
                           ckpt=ck["adaptive"], telemetry=False, **common),
        "dht": _cfg10(CAMP_FULL_N, "eclipse_publisher", (0.0, 0.1),
                      CAMP10_SEEDS, 20, EXACT_WARMUP_S, dht=dict(
                          lookup_eclipse=True, rtable_poison=True,
                          heal_hb=5), ckpt=ck["dht"], telemetry=False,
                      **common),
    }
    results = {}
    for tag, cfg in cfgs.items():
        out[tag], results[tag] = _campaign10_full(dev, tag, cfg)
    att = [t for t in results["dht"].trials if t.fraction > 0]
    check(all(t.rtable_poison_frac > 0 for t in att),
          "10(b) dht: no routing-table poison measured")
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    t1 = time.time()
    again = run_campaign(cfgs["dht"], device=dev)
    resumed = [w for w in again.phase_walls if w["fraction"] > 0]
    check(resumed and all(w["resumed"] for w in resumed),
          "10(b) dht: the rerun did not resume every attacked trial")
    check(_campaign_fields(again) == _campaign_fields(results["dht"]),
          "10(b) dht: the resumed campaign differs from the first run")
    print(f"[campaign10] 10(b) dht resumed from "
          f"{len(os.listdir(ck['dht']))} checkpoint files: same "
          f"CampaignResult outside the walls ({time.time() - t1:.1f} s, "
          f"wall_s {again.wall_s:.3f})")
    syncs = _window10_syncs(dev, cfgs["faults"])
    print(f"[campaign10] 10(b) host syncs in {cfgs['faults'].attack_heartbeats}"
          f" heartbeats: faulted window {syncs['faulted'][0]} "
          f"({syncs['faulted'][1]:.3f} s profiled), adaptive window "
          f"{syncs['adaptive'][0]} ({syncs['adaptive'][1]:.3f} s profiled)")
    return out


def _strict_json(path):
    def _refuse(tok):
        raise ValueError(f"non-strict JSON constant {tok}")

    with open(path) as f:
        return json.load(f, parse_constant=_refuse)


CAMP10C_JSON = {k: os.path.join(SCRATCH, f"camp10c_{k}.json")
                for k in ("attack", "pareto")}


def campaign10_cli_start():
    """10(c)'s `attack` and `pareto` processes, started early
    (side_start)."""
    js = CAMP10C_JSON
    argv = {
        "attack": ["attack", "--scenario", "eclipse_publisher", "-n",
                   str(CAMP10_N), "--msg-size", "2000", "--connect-to", "10",
                   "--warmup-s", "30", "--fractions", "0,0.1", "--seeds",
                   "0,1", "--attack-heartbeats", "20", "--messages", "3",
                   "--delay-s", "2", "--adaptive", "--crash-frac", "0.05",
                   "--crash-window", "2:8", "--partition-frac", "0.5",
                   "--partition-window", "4:12", "--spike-frac", "0.05",
                   "--spike-window", "0:6", "--spike-ms", "500",
                   "--dht-eclipse", "--dht-poison", "--dht-heal-hb", "5",
                   "--recovery-heartbeats", "10", "--evict", "--px",
                   "--redial", "--json", js["attack"]],
        "pareto": ["pareto", "-n", str(CAMP10_N), "--json", js["pareto"]],
    }
    for name, args in argv.items():
        side_start(f"{name}10c", port_cmd(*args))


def phase_campaign10_cli(dev):
    """10(c): at BASELINE config 6's width (2,048 peers), the `attack`
    process with fault, DHT and adaptive flags (eclipse, config 6's grid
    and depth, a 10-heartbeat recovery window) and the `pareto` process
    with its default grid (both run beside 10(a)): both exit 0 with
    strict JSON, the attack's trials all present and the sweep's front
    non-empty."""
    t0 = time.time()
    out = {}
    js = CAMP10C_JSON
    for name in ("attack", "pareto"):
        proc, wall = side_wait(f"{name}10c")
        check(proc.returncode == 0, f"10(c) {name} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        out[name] = (_strict_json(js[name]), wall,
                     proc.stdout.strip().splitlines()[-1])
    d, cli_s, last = out["attack"]
    check(len(d["trials"]) == 4, f"10(c) attack: {len(d['trials'])} trials")
    print(f"[campaign10] 10(c) attack ({CAMP10_N} peers, eclipse, "
          f"--adaptive, crash + partition + spike, --dht-eclipse "
          f"--dht-poison): exit 0 in {cli_s:.1f} s, strict JSON, wall_s "
          f"{d['wall_s']:.3f}, trials_per_s {d['trials_per_s']:.4f}; "
          f"{_worst(d)}")
    for t in d["trials"]:
        print(f"[campaign10] 10(c)   {_trial_line(t)}; {_resilience(t)}")
    sw, cli_s, last = out["pareto"]
    check(sw["pareto"], "10(c) pareto: empty front")
    print(f"[campaign10] 10(c) pareto ({CAMP10_N} peers, default grid): "
          f"exit 0 in {cli_s:.1f} s, strict JSON, {len(sw['configs'])} "
          f"points, front {sw['pareto']}, beats default "
          f"{sw['beats_default']}, sweep wall_s {sw['wall_s']:.3f}; "
          + "; ".join(f"{r['d_low']}:{r['d']}:{r['d_high']} w "
                      f"{r['slow_peer_penalty_weight']}: coverage "
                      f"{r['coverage']:.4f}, bandwidth "
                      f"{r['bandwidth_bytes']:.0f} B, recovery "
                      f"{r['recovery_time_ms']} ms" for r in sw["configs"])
          + f" ({time.time() - t0:.1f} s)")


def phase_10(dev):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    campaign10_cli_start()          # 10(c)'s processes and 13(d)'s
    microbench13d_start()           # microbench, beside 10(a)
    with shared_cores():
        phase_campaign10_parity(dev)
    side_join("campaign10", ("attack10c", "pareto10c", "microbench13d"),
              "10(a)")
    launches = phase_campaign10_full(dev)
    phase_campaign10_cli(dev)
    print(f"[campaign10] phase 10 took {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 11

# 11(b)'s arena probe: seed 0 alone since phase 14 joined the smoke (seeds
# 0 and 1 before; PERF.md section 4 lists the cut)
ARENA_SEEDS = (0,)
FUSED_PARITY_N = 512
ARENA_PARITY_N = 128
ARENA_CLI_N = 2048
# bench.py's chain: 300 timed heartbeat rounds over 3 publishes from peers
# 4, 5 and 6, from the post-warm-up state
FUSED_PUBS = (4, 5, 6)
FUSED_HB_PER_ROUND = 100
# the arena's fault cell at 11(a): the partition still open over the
# publishes
FAULTS11 = dict(crash_frac=0.1, crash_window=(1, 4), partition_frac=0.4,
                partition_window=(2, 9), spike_frac=0.1, spike_window=(0, 3),
                spike_ms=37.5)


def _exp11(n, msg_size, frags, warmup_s, messages=3, delay_s=2.0,
           anchor_stages=5, armed=True):
    """Config 4's network shape at `n` peers; `armed`: attack_gossipsub()
    with flood publish off (the arena's), else the default GossipSub."""
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime import campaign as camp
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    return ExperimentConfig(
        topo=TopoParams(
            network_size=n, anchor_stages=anchor_stages, min_bandwidth=50,
            max_bandwidth=150, min_latency=40, max_latency=130,
            msg_size_bytes=msg_size, num_frags=frags, messages=messages,
            delay_seconds=delay_s),
        connect_to=10, warmup_s=warmup_s, seed=0,
        gossipsub=(camp.attack_gossipsub(flood_publish=False) if armed
                   else GossipSubParams()))


def _fused_chain(sim, fused, hb, arms=None):
    """run_fused_rounds from the Simulator's state with its edge tables
    (the bench chain's lat_edge, ans_tables and valid_edge)."""
    from dst_libp2p_test_node_tpu_torch.ops.disseminate import (
        run_fused_rounds)

    a = sim.arrays
    return run_fused_rounds(
        sim.state, a["conns"], a["rev"], sim._stage, sim._lat, sim._bw,
        a["out_mask"], list(FUSED_PUBS),
        dataclasses.replace(sim.params, fused_rounds=fused),
        sim.cfg.topo.msg_size_bytes, hb, fragments=sim.cfg.topo.num_frags,
        lat_edge=sim._lat_edge, ans_tables=sim._ans_tables,
        valid_edge=sim._valid_edge, **(arms or {}))


def _chain_bytes(out, adaptive):
    from dst_libp2p_test_node_tpu_torch import interop

    head, res, obs = out
    state, ctrl = head if adaptive else (head, None)
    d = {"state/" + k: v for k, v in interop.state_to_numpy(state).items()}
    d.update({"res/" + f.name: getattr(res, f.name).cpu().numpy()
              for f in dataclasses.fields(res)})
    if ctrl is not None:
        d.update({"ctrl/" + k: v
                  for k, v in interop.leaves_to_numpy(ctrl).items()})
    d.update({"obs/" + k: v
              for k, v in interop.obs_to_numpy(obs).items()})
    return d


def _same_bytes(what, want, got):
    from dst_libp2p_test_node_tpu_torch import interop

    bad = interop.leaf_mismatches(want, got) + sorted(set(want) ^ set(got))
    check(not bad, f"{what}: {bad[:8]} differ")


def _arms11(case, n, d):
    """run_fused_rounds's arms for an 11(a) case, on device d."""
    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops import faults as fault_ops
    from dst_libp2p_test_node_tpu_torch.ops.telemetry import (
        TelemetryParams)

    if case == "benign":
        return {}
    if case == "adaptive":
        att = adv_ops.attacker_cohort(n, 0.25, 0, publisher=4)
        return dict(attacker=torch.as_tensor(att, device=d),
                    adv=adv_ops.AdversaryParams(
                        scenario="sybil_graft_flood",
                        adaptive=adv_ops.AdaptivePolicy(enabled=True)),
                    telemetry=TelemetryParams(record=True))
    fp = fault_ops.FaultParams(crash_frac=0.1, crash_window=(1, 4),
                               partition_frac=0.3, partition_window=(1, 3),
                               spike_frac=0.2, spike_window=(0, 4),
                               spike_ms=50.0)
    m = fault_ops.fault_masks(n, fp, 0, publisher=FUSED_PUBS[0])
    return dict(attacker=torch.zeros(n, dtype=torch.bool, device=d),
                adv=adv_ops.AdversaryParams(), faults=fp,
                **{k: torch.as_tensor(v, device=d) for k, v in m.items()})


def _arena_cfg(exp, seeds, steps, faults=None):
    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops.faults import FaultParams
    from dst_libp2p_test_node_tpu_torch.runtime import campaign as camp

    return camp.CampaignConfig(
        scenario="sybil_graft_flood", fractions=(0.25,), seeds=seeds,
        experiment=exp,
        adversary=adv_ops.AdversaryParams(
            scenario="sybil_graft_flood",
            adaptive=adv_ops.AdaptivePolicy(enabled=True)),
        attack_heartbeats=steps, faults=FaultParams(**(faults or {})))


def phase_fused_arena_parity(dev):
    """11(a), on the card and on the CPU: run_fused_rounds at 512 peers,
    split and fused, benign / adaptive + telemetry / faults (crash +
    partition + spike on a zero-attacker cohort), 3 rounds of 4
    heartbeats and a publish: every state leaf, result, controller and
    curve the same bytes in all four runs; then run_arena_campaign at 128
    peers (benign + sybil_graft_flood against the adaptive attacker,
    seeds 0 and 1), without and with faults: the artifact equal outside
    wall_s."""
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        run_arena_campaign)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    t0 = time.time()
    n = FUSED_PARITY_N
    for case in ("benign", "adaptive", "faults"):
        runs = []
        for d in (dev, torch.device("cpu")):
            sim = Simulator(_exp11(n, 2000, 1, 10.0, anchor_stages=3),
                            device=d)
            sim.warmup()
            for fused in (False, True):
                runs.append(_chain_bytes(
                    _fused_chain(sim, fused, 4, _arms11(case, n, d)),
                    case == "adaptive"))
        for i, what in enumerate(("CUDA split", "CUDA fused", "CPU fused")):
            _same_bytes(f"11(a) fused {case}: {what} against CPU split",
                        runs[2], runs[(0, 1, 3)[i]])
        check(runs[2]["res/received"].any(),
              f"11(a) fused {case}: nothing delivered")
    arena = {}
    for tag, faults in (("plain", None), ("faults", FAULTS11)):
        got = []
        for d in (dev, torch.device("cpu")):
            cfg = _arena_cfg(_exp11(ARENA_PARITY_N, 2000, 1, 8.0,
                                    messages=2, delay_s=0.5,
                                    anchor_stages=3), (0, 1), 6, faults)
            art = run_arena_campaign(cfg, device=d)
            art.pop("wall_s")
            got.append(art)
        check(got[0] == got[1], f"11(a) arena {tag}: CUDA and CPU differ")
        arena[tag] = got[0]
    rows = "; ".join(
        f"{tag} {r['scenario']}/{r['protocol']} coverage "
        f"{r['coverage']:.4f} bandwidth {r['bandwidth_bytes']:.0f} B"
        for tag, art in arena.items() for r in art["rows"])
    print(f"[arena] 11(a) run_fused_rounds at {n} peers (benign, adaptive "
          f"+ telemetry, faults), split and fused: CUDA = CPU in every "
          f"leaf; run_arena_campaign at {ARENA_PARITY_N} peers, plain and "
          f"faulted: CUDA = CPU in every field ({time.time() - t0:.1f} s);"
          f" {rows}")


def _episub_window_syncs(dev, exp):
    """Host syncs (aten::_local_scalar_dense) and profiled wall of one
    episub adaptive window (sybil_graft_flood, fraction 0.25, 20 rounds)
    from an episub-warmed tree at the arena's shape."""
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.ops import adversary as adv_ops
    from dst_libp2p_test_node_tpu_torch.ops import episub as ep_ops
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    sim = Simulator(exp, device=dev)
    n = sim.params.n
    a = sim.arrays
    g = (a["conns"], a["rev"], a["out_mask"])
    ep = ep_ops.EpisubParams(root=exp.publisher_id % n)
    warm = int(exp.warmup_s * 1000.0 // sim.params.heartbeat_ms)
    st, ct = ep_ops.run_episub_heartbeats(
        sim.state, ep_ops.init_episub_ctrl(n, dev), *g, sim.params, ep, warm)
    att = torch.as_tensor(adv_ops.attacker_cohort(
        n, 0.25, 0, conns=sim.graph.conns, publisher=4), device=dev)
    adv = adv_ops.AdversaryParams(
        scenario="sybil_graft_flood",
        adaptive=adv_ops.AdaptivePolicy(enabled=True))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time()
        ep_ops.run_episub_adaptive_heartbeats(st, ct, *g, att, sim.params,
                                              ep, adv, 20)
        torch.cuda.synchronize()
        wall = time.time() - t0
    return (sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense"), wall)


def phase_fused_arena_full(dev):
    """11(b) on 9(c)'s network (100,000 peers, connect_to 10, 5 anchor
    stages, 40-130 ms, 50-150 Mbit, 4 fragments of a 15,000 B message,
    exact, a 60 s warm-up, no churn): the bench chain (3 rounds of 100
    heartbeats and a publish from peers 4, 5 and 6, the post-warm-up
    state, the Simulator's edge tables) split and then fused, the same
    bytes, walls, peer-rounds/s and launches; then the arena (benign +
    sybil_graft_flood against the default adaptive policy, fraction
    0.25, seed 0 (seeds 0 and 1 until phase 14 joined), 20 attack
    heartbeats, 3 messages 2 s apart, flood publish off: 4 trials) gated
    as the reference's probe gates it,
    with its launches, peak memory and the host syncs of one episub
    adaptive window. Returns {"split", "fused", "arena"} launches."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        run_arena_campaign)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    n = CAMP_FULL_N
    out = {}
    ts = time.time()
    sim = Simulator(_exp11(n, 15000, 4, EXACT_WARMUP_S, armed=False),
                    device=dev)
    sim.warmup()
    torch.cuda.synchronize()
    print(f"[arena] 11(b) chain set-up and warm-up {time.time() - ts:.3f} s")
    chains = {}
    for mode in ("split", "fused"):
        vg.launches = 0
        su.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = _fused_chain(sim, mode == "fused", FUSED_HB_PER_ROUND)
        torch.cuda.synchronize()
        wall = time.time() - t0
        out[mode] = {"vmem_gather": vg.launches, "score_update": su.launches}
        chains[mode] = _chain_bytes(res, False)
        rate = n * len(FUSED_PUBS) * FUSED_HB_PER_ROUND / wall
        recv = chains[mode]["res/received"]
        delays = chains[mode]["res/delay_ms"][recv]
        print(f"[arena] 11(b) {mode} chain: {len(FUSED_PUBS)} rounds x "
              f"{FUSED_HB_PER_ROUND} heartbeats + publish at {n} peers x "
              f"4 fragments: wall {wall:.3f} s, "
              f"{rate:.1f} simulated peer-rounds/s, coverage "
              f"{recv.mean():.5f}, p50 {np.percentile(delays, 50):.3f} ms, "
              f"p99 {np.percentile(delays, 99):.3f} ms, converged "
              f"{bool(chains[mode]['res/converged'].all())}; launches "
              f"{out[mode]}")
        for name, count in out[mode].items():
            check(count > 0, f"11(b) {mode} chain never launched {name}")
    _same_bytes("11(b) the fused chain against the split one",
                chains["split"], chains["fused"])
    check(chains["split"]["res/converged"].all(),
          "11(b): a chain publish did not converge")
    del sim, chains

    exp = _exp11(n, 15000, 4, EXACT_WARMUP_S)
    cfg = _arena_cfg(exp, ARENA_SEEDS, 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    art = run_arena_campaign(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    out["arena"] = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    rate = len(art["trials"]) / art["wall_s"]
    print(f"[arena] 11(b) arena at {n} peers x 4 fragments (benign + "
          f"sybil_graft_flood, adaptive, fraction 0.25, seeds "
          f"{'/'.join(map(str, ARENA_SEEDS))}, 20 "
          f"attack heartbeats, 3 messages): {len(art['trials'])} trials, "
          f"wall_s {art['wall_s']:.3f} ({wall:.3f} s with set-up), "
          f"arena_trials_per_s {rate:.4f}; launches {out['arena']}; peak "
          f"memory {peak / 2**30:.2f} GiB; wins {art['wins']}")
    for r in art["rows"]:
        print(f"[arena] 11(b)   {r['scenario']}/{r['protocol']}: coverage "
              f"{r['coverage']:.5f}, p50 {r['latency_p50_ms']} ms, p99 "
              f"{r['latency_p99_ms']} ms, bandwidth "
              f"{r['bandwidth_bytes']:.0f} B, recovery "
              f"{r['recovery_time_ms']} ms")
    for t in art["trials"]:
        extra = ", ".join(f"{k} {v:.4f}" for k, v in t.items()
                          if k.endswith("_final"))
        print(f"[arena] 11(b)     {t['scenario']}/{t['protocol']} seed "
              f"{t['seed']}: coverage {t['coverage']:.5f}, attackers "
              f"{t['attackers']}, recovery {t['recovery_time_ms']} ms"
              + (f", {extra}" if extra else ""))
    rows = {(r["scenario"], r["protocol"]): r for r in art["rows"]}
    for proto in ("gossipsub", "episub"):
        cov = rows[("benign", proto)]["coverage"]
        check(cov >= 0.95, f"11(b) arena: benign coverage {cov} < 0.95 "
              f"for {proto}")
    bw_g = rows[("benign", "gossipsub")]["bandwidth_bytes"]
    bw_e = rows[("benign", "episub")]["bandwidth_bytes"]
    check(bw_e < bw_g, f"11(b) arena: episub's benign bandwidth {bw_e} is "
          f"not below GossipSub's {bw_g}")
    for name, count in out["arena"].items():
        check(count > 0, f"11(b) arena never launched {name}")
    syncs, swall = _episub_window_syncs(dev, exp)
    print(f"[arena] 11(b) host syncs in one episub adaptive window of 20 "
          f"heartbeats: {syncs} ({swall:.3f} s profiled)")
    return out


ARENA11C_JSON = os.path.join(SCRATCH, "arena11c.json")


def arena11c_start():
    """11(c)'s `arena` process, started early (side_start)."""
    side_start("arena11c", port_cmd("arena", "-n", str(ARENA_CLI_N),
                                    "--json", ARENA11C_JSON))


def phase_arena_cli(dev):
    """11(c): the `arena` process at 2,048 peers (the command's defaults
    otherwise; run beside 11(a)) with --json: exit 0, strict JSON, every
    trial present."""
    js = ARENA11C_JSON
    proc, wall = side_wait("arena11c")
    check(proc.returncode == 0, f"11(c) arena exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    art = _strict_json(js)
    check(len(art["trials"]) == 8, f"11(c) arena: {len(art['trials'])} "
          "trials")
    print(f"[arena] 11(c) arena ({ARENA_CLI_N} peers): exit 0 in "
          f"{wall:.1f} s beside 11(a), strict JSON, wall_s "
          f"{art['wall_s']:.3f}, win_counts {art['win_counts']}, ties "
          f"{art['ties']}; "
          + "; ".join(f"{r['scenario']}/{r['protocol']} coverage "
                      f"{r['coverage']:.4f}, bandwidth "
                      f"{r['bandwidth_bytes']:.0f} B, recovery "
                      f"{r['recovery_time_ms']} ms" for r in art["rows"]))


def phase_11(dev):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    arena11c_start()                # beside 11(a): 11(c)'s arena and
    grid14d_start()                 # 14(d)'s attack --trial-groups 0
    with shared_cores():
        phase_fused_arena_parity(dev)
    for name in ("arena11c", "grid14d"):
        side_wait(name)
    launches = phase_fused_arena_full(dev)
    phase_arena_cli(dev)
    print(f"[arena] phase 11 took {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 12

CONFORM_SEEDS = (0, 1)
# the canon of conformance_certificate's entries, in its order
CONFORM_CANON = ("sybil_graft_flood", "ihave_spam", "iwant_spam",
                 "censorship", "eclipse_publisher", "cold_boot_join",
                 "slow_peer_mimicry", "identity_rotation", "adaptive",
                 "faults", "churn", "opportunistic_graft", "gossip_fragments")
PLAN_N = PARITY_N
# (name, answer_queue_mode, the engine the route must take)
PLAN_ROUTES = (("prefix", "parallel_prefix", "prefix"),
               ("serial", "serial", "serial"))
# (name, per-edge loss, loss model)
PLAN_LOSSES = (("lossless", 0.0, "tcp"), ("tcp 1%", 0.01, "tcp"),
               ("message 1%", 0.01, "message"))
TRACE_PARITY_N = 64
TRACE_N = EXACT_N
# cut from 20 and 10 to keep the whole smoke within its time line
TRACE_HB = 10
TRACE_WARMUP_HB = 5


class _SimStates:
    """Records every sim-side state the conformance walks compare (the
    argument of analysis.conformance._diff_states, per round and for the
    runner-coherence finals) as host numpy, in call order."""

    def __enter__(self):
        from dst_libp2p_test_node_tpu_torch import interop
        from dst_libp2p_test_node_tpu_torch.analysis import conformance

        self.states = []
        self._orig = conformance._diff_states

        def _diff_states(sim_state, spec_st, scenario, seed, step,
                         prefix=""):
            self.states.append(((scenario, seed, step, prefix),
                                interop.state_to_numpy(sim_state)))
            return self._orig(sim_state, spec_st, scenario, seed, step,
                              prefix=prefix)

        conformance._diff_states = _diff_states
        return self

    def __exit__(self, *exc):
        from dst_libp2p_test_node_tpu_torch.analysis import conformance

        conformance._diff_states = self._orig


def _plan_bytes(plan):
    return {k: v.cpu().numpy() for k, v in plan.items() if v is not None}


def _publish_bytes(res, state, plan=None):
    from dst_libp2p_test_node_tpu_torch import interop

    d = {"res/" + f.name: getattr(res, f.name).cpu().numpy()
         for f in dataclasses.fields(res)}
    d.update({"state/" + k: v
              for k, v in interop.state_to_numpy(state).items()})
    if plan is not None:
        d.update({"plan/" + k: v for k, v in _plan_bytes(plan).items()})
    return d


def _sim_publish(sim, params=None, loss=0.0, loss_mode=None, **extra):
    """One disseminate from the Simulator's state with its edge tables, as
    Simulator.publish calls it (publisher cfg.publisher_id, no mix), at a
    per-edge `loss` other than the topology's when given."""
    from dst_libp2p_test_node_tpu_torch.ops.disseminate import disseminate

    cfg = sim.cfg
    a = sim.arrays
    loss_kw = dict(loss_stage=sim._loss, loss_edge=sim._loss_edge)
    if loss:
        s1 = sim._lat.shape[0]
        loss_kw = dict(loss_stage=torch.full((s1, s1), loss,
                                             dtype=torch.float32,
                                             device=sim.device))
    return disseminate(
        sim.state, a["conns"], a["rev"], sim._stage, sim._lat, sim._bw,
        publisher=cfg.publisher_id,
        t0_ms=float(sim.state.t_ms) + sim._hb_carry_ms,
        params=params or sim.params, payload_bytes=cfg.topo.msg_size_bytes,
        fragments=cfg.topo.num_frags, with_gossip=cfg.with_gossip,
        loss_mode=loss_mode or cfg.loss_mode, lat_edge=sim._lat_edge,
        ans_tables=sim._ans_tables, valid_edge=sim._valid_edge,
        **loss_kw, **extra)


def _trace_cli(dev, n, out, hb, warm, profile_dir=None):
    """The `trace` command in this process; returns its summary."""
    from dst_libp2p_test_node_tpu_torch import cli

    argv = ["trace", "-n", str(n), "--heartbeats", str(hb), "--warmup-hb",
            str(warm), "--out", out, "--device", str(dev)]
    if profile_dir:
        argv += ["--profile-dir", profile_dir]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"trace on {dev} exited {rc}")
    return json.loads(buf.getvalue())


def _trace_files(out):
    files = {}
    for name in ("trace.perfetto.json", "rounds.csv"):
        with open(os.path.join(out, name), "rb") as f:
            files[name] = f.read()
    with np.load(os.path.join(out, "rounds.npz")) as z:
        files.update({"npz/" + k: z[k] for k in z.files})
    return files


def phase_conformance_parity(dev):
    """12(a): the full conformance canon (8 scenarios + adaptive, faults,
    churn, opportunistic graft, gossip_fragments) at seeds 0 and 1 on the
    card and on the CPU: certificates equal entry by entry, every sim
    state the walks compare bitwise equal; both mutants classified sim_bug
    on the card; the seed-0 certificate on the card (12(d)'s reference);
    disseminate(return_plan=True) at 2,048 peers on the prefix and serial
    routes, lossless and at 1% tcp and message loss: plan, result and state
    leaves bitwise CUDA = CPU; `trace` at 64 peers: its files CUDA = CPU.
    Returns the seed-0 certificate."""
    from dst_libp2p_test_node_tpu_torch.analysis import conformance as conf
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.ops import disseminate as dis
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    cpu = torch.device("cpu")
    certs, walks, walls = [], [], []
    for d in (dev, cpu):
        t0 = time.time()
        with _SimStates() as rec:
            certs.append(conf.conformance_certificate(
                seeds=CONFORM_SEEDS, device=d))
        walls.append(time.time() - t0)
        walks.append(rec.states)
    gpu, host = certs
    names = [e["scenario"] for e in gpu["entries"]]
    check(tuple(names) == CONFORM_CANON, f"12(a) canon entries {names}")
    for eg, ec in zip(gpu["entries"], host["entries"]):
        check(eg == ec, f"12(a) {eg['scenario']}: the certificate entry "
              f"differs between CUDA ({eg}) and the CPU ({ec})")
    check(gpu == host, "12(a) certificates differ outside the entries")
    check(gpu["clean"], f"12(a) certificate not clean: {gpu['sim_bugs']} "
          "sim_bug(s)")
    (wait,) = [d["max_abs_err"] for e in gpu["entries"]
               if e["scenario"] == "gossip_fragments"
               for d in e["divergences"]]
    wg, wc = walks
    check([k for k, _ in wg] == [k for k, _ in wc],
          "12(a) the walks compared other rounds on the two devices")
    for (key, sg), (_, sc) in zip(wg, wc):
        bad = sorted(k for k in sg if sg[k].tobytes() != sc[k].tobytes())
        check(not bad, f"12(a) {key}: sim state leaves {bad} differ "
              "between CUDA and the CPU")
    print(f"[conform] 12(a) canon x seeds {list(CONFORM_SEEDS)}: "
          f"{len(names)} entries equal on CUDA ({walls[0]:.1f} s) and "
          f"the CPU ({walls[1]:.1f} s), clean, statuses "
          + ", ".join(f"{e['scenario']} {e['status']}"
                      for e in gpu["entries"])
          + f"; gossip_fragments wait {wait!r} ms; {len(wg)} sim states "
          "bitwise equal")
    t0 = time.time()
    for name, mutant in conf.MUTANTS.items():
        divs = conf.run_scenario_differential("sybil_graft_flood",
                                              mutate=mutant, device=dev)
        classes = {d["classification"]
                   for d in conf.classify(divs, conf.load_waivers())}
        check(divs and classes == {"sim_bug"},
              f"12(a) mutant {name}: {len(divs)} divergences, {classes}")
        print(f"[conform] 12(a) mutant {name}: {len(divs)} divergences on "
              f"CUDA, all sim_bug (fields "
              f"{sorted({d['field'] for d in divs})})")
    cert0 = conf.conformance_certificate(seeds=(0,), device=dev)
    check(cert0["clean"], "12(a) seed-0 certificate not clean")
    print(f"[conform] 12(a) mutants and the seed-0 certificate on CUDA: "
          f"{time.time() - t0:.1f} s")

    t0 = time.time()
    topo = TopoParams(network_size=PLAN_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=2,
                      messages=3, delay_seconds=2.0)
    cfg = ExperimentConfig(
        topo=topo, seed=3, warmup_s=30.0,
        gossipsub=GossipSubParams(flood_publish=False, d_lazy=12))
    out = {}
    for i, d in enumerate((dev, cpu)):
        sim = Simulator(cfg, device=d)
        sim.warmup()
        for rname, mode, engine in PLAN_ROUTES:
            params = dataclasses.replace(sim.params, answer_queue_mode=mode)
            for lname, loss, model in PLAN_LOSSES:
                dis.reset_engine_counts()
                res, state, plan = _sim_publish(
                    sim, params, loss, model, return_plan=True)
                out[(i, rname, lname)] = (
                    _publish_bytes(res, state, plan), dict(dis.engine_counts),
                    {k: None if v is None else tuple(v.shape)
                     for k, v in plan.items()})
    for rname, _, engine in PLAN_ROUTES:
        for lname, _, _ in PLAN_LOSSES:
            (bg, cg, shapes), (bc, cc, _) = (out[(0, rname, lname)],
                                             out[(1, rname, lname)])
            _same_bytes(f"12(a) plan, {rname} route, {lname}", bc, bg)
            check(cg == cc and cg[engine] == 1,
                  f"12(a) plan, {rname} route, {lname}: engines {cg} on "
                  f"CUDA, {cc} on the CPU")
            print(f"[conform] 12(a) return_plan at {PLAN_N} peers x 2 "
                  f"fragments, {rname} route, {lname}: plan, result and "
                  f"state leaves bitwise CUDA = CPU; plan {shapes}")
    print(f"[conform] 12(a) plan parity took {time.time() - t0:.1f} s")

    t0 = time.time()
    tr = []
    for i, d in enumerate((dev, cpu)):
        o = os.path.join(SCRATCH, f"trace12a_{i}")
        _trace_cli(d, TRACE_PARITY_N, o, 20, 10)
        tr.append(_trace_files(o))
    _same_bytes(f"12(a) trace at {TRACE_PARITY_N} peers", tr[1], tr[0])
    print(f"[conform] 12(a) trace at {TRACE_PARITY_N} peers: "
          "trace.perfetto.json, rounds.csv and every rounds.npz member "
          f"equal on CUDA and the CPU ({time.time() - t0:.1f} s)")
    return cert0


# 12(b)'s seeds (0, 1 until phase 17 joined the smoke; PERF.md section 4
# lists the cut)
CONFORM12_SEEDS = (0,)


def phase_conformance_campaign(dev, cert0):
    """12(b): one campaign on 9(c)'s network (100,000 peers x 4 fragments
    of 15,000 B, exact, 60 s warm-up) armed as 10(c)'s `attack`:
    eclipse_publisher with the adaptive attacker (default policy) and
    10(b)'s fault schedule, the DHT arm off; fractions 0 / 0.1 x seeds
    CONFORM12_SEEDS, 20 attack and 10 recovery heartbeats (evict + px +
    redial),
    conformance=True. The attached certificate must be clean and hold the
    scenario, adaptive and faults entries, each equal to 12(a)'s seed-0
    entry of the same name; both kernels must launch (counts zeroed just
    before, read just after)."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime import campaign as camp

    cfg = dataclasses.replace(
        _cfg10(CAMP_FULL_N, "eclipse_publisher", (0.0, 0.1),
               CONFORM12_SEEDS, 20, EXACT_WARMUP_S, faults=FAULTS10,
               adaptive=True, msg_size=15000, frags=4, recovery=10,
               telemetry=False),
        conformance=True)
    cert_s = []
    orig = camp._campaign_conformance

    def _timed(*args, **kw):
        t = time.time()
        try:
            return orig(*args, **kw)
        finally:
            cert_s.append(time.time() - t)

    camp._campaign_conformance = _timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vg.launches = 0
        su.launches = 0
        res = camp.run_campaign(cfg, device=dev)
        torch.cuda.synchronize()
        launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    finally:
        camp._campaign_conformance = orig
    peak = torch.cuda.max_memory_allocated(dev)
    cert = res.conformance
    want = {e["scenario"]: e for e in cert0["entries"]}
    names = [e["scenario"] for e in cert["entries"]]
    check(names == ["eclipse_publisher", "adaptive", "faults"],
          f"12(b) certificate entries {names}")
    check(cert["clean"], f"12(b) certificate not clean: {cert}")
    for e in cert["entries"]:
        check(e == want[e["scenario"]],
              f"12(b) {e['scenario']}: {e} differs from 12(a)'s "
              f"{want[e['scenario']]}")
    check(res.to_dict()["conformance"] == cert,
          "12(b) the certificate does not ride to_dict()")
    for k, v in launches.items():
        check(v > 0, f"12(b) the campaign never launched {k}")
    d = res.to_dict()
    print(f"[conform] 12(b) {CAMP_FULL_N} peers x 4 fragments, "
          f"eclipse_publisher + adaptive + crash/partition/spike, fractions "
          f"0/0.1 x seeds {CONFORM12_SEEDS}, 20 attack + 10 recovery "
          f"heartbeats, "
          f"conformance=True: wall_s {res.wall_s:.3f} (certificate "
          f"{cert_s[0]:.3f} s), trials_per_s {res.trials_per_s:.4f}; "
          f"certificate clean, entries {names} equal to 12(a)'s; launches "
          f"{launches}; peak memory {peak / 2**30:.2f} GiB; {_worst(d)}")
    for t in d["trials"]:
        print(f"[conform] 12(b)   {_trial_line(t)}; {_resilience(t)}")
    return launches


def _lossy_config4():
    """Phase 3d's lossy config 4 (packet loss 0.01, tcp, slow-peer weight
    -1), as its `run` arguments build it."""
    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.config.env import (
        gossipsub_params_from_env)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    saved = {k: os.environ.get(k) for k in LOSSY_ENV}
    os.environ.update(LOSSY_ENV)
    try:
        gs = gossipsub_params_from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ExperimentConfig(
        topo=_topo_from_fields(dict(zip(RUN_SH_PARAMS, LOSSY_ARGS))),
        gossipsub=gs, warmup_s=EXACT_WARMUP_S,
        churn_down_per_hb=EXACT_CHURN, churn_up_per_hb=EXACT_CHURN / 2)


def phase_plan_full(dev):
    """12(c): one exact publish of 3d's lossy config 4 at full width
    (100,000 peers x 4 fragments, tcp loss 0.01, slow-peer weight -1) from
    the post-warm-up state, without and with return_plan: result and new
    state the same bytes. Counts zeroed before the Simulator is built and
    read after the two publishes."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _lossy_config4()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    sim = Simulator(cfg, device=dev)
    sim.warmup()
    torch.cuda.synchronize()
    t1 = time.time()
    res, state = _sim_publish(sim)
    torch.cuda.synchronize()
    t2 = time.time()
    g0 = vg.launches
    res_p, state_p, plan = _sim_publish(sim, return_plan=True)
    torch.cuda.synchronize()
    t3 = time.time()
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    _same_bytes("12(c) publish with return_plan", _publish_bytes(res, state),
                _publish_bytes(res_p, state_p))
    check(plan["survive"] is not None and plan["retx_ms"] is not None,
          "12(c) the lossy plan carries no loss draws")
    for k, v in launches.items():
        check(v > 0, f"12(c) the run never launched {k}")
    nbytes = sum(v.numel() * v.element_size() for v in plan.values()
                 if v is not None)
    shapes = {k: None if v is None else tuple(v.shape)
              for k, v in plan.items()}
    cov = float(res.received.float().mean())
    print(f"[plan] 12(c) {EXACT_N} peers x 4 fragments, tcp loss 0.01, "
          f"slow weight -1: set-up + warm-up {t1 - t0:.1f} s, publish "
          f"{t2 - t1:.3f} s, with return_plan {t3 - t2:.3f} s; result and "
          f"state bytes equal; coverage {cov:.6f}; plan {shapes}, "
          f"{nbytes / 2**20:.1f} MiB; peak memory {peak / 2**30:.2f} GiB; "
          f"vmem_gather launches {g0} + {vg.launches - g0} (plan publish), "
          f"launches {launches}")
    return launches


CONFORM12D_OUT = os.path.join(SCRATCH, "cert12_cli.json")
TRACE12D_OUT = os.path.join(SCRATCH, "trace12d")
TRACE12D_PROF = os.path.join(SCRATCH, "trace12d_prof")


def trace12d_start(dev):
    """12(d)'s `trace` process, started early (side_start)."""
    side_start("trace12d", port_cmd(
        "trace", "-n", str(TRACE_N), "--heartbeats", str(TRACE_HB),
        "--warmup-hb", str(TRACE_WARMUP_HB), "--out", TRACE12D_OUT,
        "--profile-dir", TRACE12D_PROF, "--device", dev.type))


def phase_conformance_cli(dev, cert0):
    """12(d): `conform --device cuda --out X` as a process (run beside
    12(a)): exit 0, its file equal to 12(a)'s seed-0 certificate written
    by write_certificate; `trace -n 100000 --heartbeats 10 --warmup-hb 5
    --profile-dir D` as a process (run beside 9(a)): exit 0, strict-JSON
    trace.perfetto.json, 10 rows in rounds.csv, and a profiler trace in D
    that names the score_update kernel. Returns the trace's device kernel
    launches (the profiler's count)."""
    from dst_libp2p_test_node_tpu_torch.analysis import conformance as conf
    from dst_libp2p_test_node_tpu_torch.runtime import profiling

    want = os.path.join(SCRATCH, "cert12_want.json")
    conf.write_certificate(cert0, want)
    got, out, prof = CONFORM12D_OUT, TRACE12D_OUT, TRACE12D_PROF
    walls = {}
    for name in ("conform", "trace"):
        proc, walls[name] = side_wait(f"{name}12d")
        check(proc.returncode == 0, f"12(d) {name} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        if name == "trace":
            summary = json.loads(proc.stdout)
    with open(want, "rb") as f, open(got, "rb") as g:
        check(f.read() == g.read(),
              "12(d) conform's certificate differs from 12(a)'s seed 0")
    _strict_json(got)
    _strict_json(os.path.join(out, "trace.perfetto.json"))
    with open(os.path.join(out, "rounds.csv")) as f:
        rows = f.read().splitlines()[1:]
    check(len(rows) == TRACE_HB, f"12(d) rounds.csv has {len(rows)} rows")
    with open(os.path.join(prof, profiling.PROFILE_TRACE)) as f:
        check("score_update" in f.read(),
              "12(d) the profiler trace does not name score_update")
    with open(os.path.join(prof, profiling.KERNEL_COUNTS)) as f:
        kernels = json.load(f)
    launches = {k: sum(v for name, v in kernels.items() if k in name)
                for k in ("vmem_gather", "score_update")}
    top = [(name[:60], k) for name, k in
           sorted(kernels.items(), key=lambda kv: -kv[1])[:3]]
    print(f"[conform] 12(d) conform --device cuda: exit 0 in "
          f"{walls['conform']:.1f} s beside 12(a), its file equals 12(a)'s "
          f"seed-0 certificate; trace -n {TRACE_N} --heartbeats {TRACE_HB} "
          f"--warmup-hb {TRACE_WARMUP_HB} --profile-dir: exit 0 in "
          f"{walls['trace']:.1f} s beside 9(a), strict JSON, {len(rows)} "
          f"rows, "
          f"coverage90_hb {summary['coverage90_hb']}, final mean degree "
          f"{summary['final_mean_degree']:.4f}; the profiler saw "
          f"{sum(kernels.values())} kernel launches of {len(kernels)} "
          f"kernels ({launches}); most launched {top}")
    check(launches["score_update"] > 0,
          "12(d) the profiler saw no score_update launch")
    return launches


def phase_12(dev):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    # beside 12(a): 17(c, d)'s lint, 12(d)'s conform and 14(b)'s ranks
    lint17_start()
    side_start("conform12d", port_cmd("conform", "--device", dev.type,
                                      "--out", CONFORM12D_OUT))
    grid14_start(dev)
    with shared_cores():
        cert0 = phase_conformance_parity(dev)
    side_join("conform", ("lint17", "conform12d"), "12(a)")
    grid14_ready()
    launches = {"conformance_campaign": phase_conformance_campaign(dev,
                                                                   cert0)}
    launches["plan"] = phase_plan_full(dev)
    launches["trace"] = phase_conformance_cli(dev, cert0)
    print(f"[conform] phase 12 took {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 13

# slack around this run's phase 2 time that the sweep's default launch
# must land inside: both are L2-cold means of 20 launches (the sweep the
# least of 3, phase 2 the lesser of 2)
PHASE2_SLACK = 0.10


def _phase2_ms(kernels, name, rows):
    """Phase 2's time of sweep row `name` at `rows` x 40."""
    if name == "score_update_decay_only":
        return kernels["score_update"]["decay_only"][str(rows)]["ms"]
    k = kernels[name]
    return {EXACT_N: k["exact"], SVC_ROWS: k["service"], FULL_N: k}[rows][
        "ms"]


def phase_registry_parity(dev):
    """13(a): every registered contract's spec on the card and on the CPU:
    every output leaf the same bytes; the feedback checks (and the memory
    budgets on the card) and the runtime invariants hold on both."""
    from dst_libp2p_test_node_tpu_torch.analysis.contracts import (
        numpy_leaves)
    from dst_libp2p_test_node_tpu_torch.analysis.jaxpr_audit import (
        audit_contracts, run_checkify, run_spec)
    from dst_libp2p_test_node_tpu_torch.analysis.registry import (
        default_contracts)

    t0 = time.time()
    gpu, cpu = default_contracts(dev), default_contracts("cpu")
    check([c.name for c in gpu] == [c.name for c in cpu] and len(gpu) == 20,
          "13(a): the registry is not the 20 contracts on both devices")
    n_leaves = 0
    for g, c in zip(gpu, cpu):
        got = numpy_leaves(run_spec(g.build()))
        want = numpy_leaves(run_spec(c.build()))
        check(sorted(got) == sorted(want), f"13(a) {g.name}: leaf sets "
              f"differ ({sorted(set(got) ^ set(want))[:4]})")
        bad = [k for k in want if got[k].dtype != want[k].dtype
               or got[k].shape != want[k].shape
               or got[k].tobytes() != want[k].tobytes()]
        check(not bad, f"13(a) {g.name}: CUDA != CPU at {bad[:6]}")
        n_leaves += len(want)
    violations = (audit_contracts(gpu) + audit_contracts(cpu)
                  + run_checkify(gpu) + run_checkify(cpu))
    check(not violations, f"13(a) contract findings: {violations[:3]}")
    print(f"[tooling] 13(a) {len(gpu)} contracts on the card and on the CPU: "
          f"{n_leaves} output leaves the same bytes; feedback, memory "
          f"budgets and runtime checks clean on both ({time.time() - t0:.1f}"
          f" s)")


def phase_microbench(dev, kernels, table):
    """13(b): microbench in-process (rooflines of the 20 contracts, the
    sweep of both kernels at the three main-path shapes, --install into
    `table`), counts zeroed just before and read just after. Every
    candidate was held against the plain version by the sweep; prints each
    candidate's time, the winner and its share of the bound, the default
    launch beside this run's phase 2 (within PHASE2_SLACK; both L2-cold),
    and the rooflines."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import tuned
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime import microbench as mb

    os.environ["DST_TUNED_JSON"] = table
    tuned.invalidate_cache()
    art_path = os.path.join(SCRATCH, "microbench13.json")
    torch.cuda.synchronize()
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    art = mb.run(["--device", dev.type, "--no-packed", "--install",
                  "--reps", "3", "--out", art_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    _strict_json(art_path)
    check([s["n_rows"] for s in art["kernel_sweep"]] == list(mb.SWEEP_ROWS),
          "13(b): the sweep did not cover the three main-path shapes")
    check(all(set(s["kernels"]) == {"vmem_gather", "score_update",
                                    "score_update_decay_only"}
              for s in art["kernel_sweep"]),
          "13(b): the sweep did not time both kernels and both forms of "
          "score_update")
    print(f"[tooling] 13(b) microbench: {wall:.1f} s, launches {launches}; "
          f"gather candidates 1-{max(mb.gather_candidates(dev))} blocks "
          f"per SM (the kernel's occupancy), every candidate equal to the "
          f"plain version")
    off = []
    for sw in art["kernel_sweep"]:
        rows = sw["n_rows"]
        for name, e in sw["kernels"].items():
            param = e["param"]
            cands = ", ".join(f"{v} {w * 1e3:.4f}"
                              for v, w in e["candidates"].items())
            best, default = e[f"best_{param}"], e["default_wall_s"] * 1e3
            p2 = _phase2_ms(kernels, name, rows)
            best_ms = e["best_wall_s"] * 1e3
            print(f"[tooling] 13(b) {name} at {rows}x{sw['cap']}, ms by "
                  f"{param}: {cands}; winner {best} {best_ms:.4f} ms "
                  f"({e['best_share']:.1%} of the "
                  f"{e['bound_s'] * 1e3:.4f} ms bound); default "
                  f"{e['default']} {default:.4f} ms, phase 2 {p2:.4f} ms "
                  f"({default / p2 - 1:+.1%})")
            if not (p2 * (1 - PHASE2_SLACK) <= default
                    <= p2 * (1 + PHASE2_SLACK)):
                off.append(f"{name} at {rows}: {default:.4f} ms, phase 2 "
                           f"{p2:.4f} ms")
    check(not off, f"13(b) default launches more than {PHASE2_SLACK:.0%} "
          f"off this run's phase 2: {off}")
    print(f"[tooling] 13(b) tuned table {art['tuned']} installed at "
          f"{os.path.relpath(art['tuned_installed'], ROOT)}")
    roof = art["rooflines"]
    check(len(roof) == 20, f"13(b): {len(roof)} rooflines, want 20")
    for name, e in roof.items():
        check("error" not in e, f"13(b) roofline {name}: {e.get('error')}")
        check(e["retraces"] <= e["retrace_budget"],
              f"13(b) {name} retraced {e['retraces']} times on a warm call")
        print(f"[tooling] 13(b) roofline {name}: wall {e['wall_s'] * 1e3:.3f}"
              f" ms, bound {e['bound_s'] * 1e6:.3f} us ({e['hbm_bytes']:.0f}"
              f" B), share {e['share']:.3e}, peak {e['peak_memory_bytes']}"
              f" B, host syncs {e['host_syncs']}, retraces {e['retraces']} "
              f"(budget {e['retrace_budget']}), new segments "
              f"{e['new_segments']}")
    return launches


def phase_tuned_publish(dev, table):
    """13(c): config 4's exact publish (3b(c)'s) from one warm state,
    without the installed table, with it, and without it again: the same
    delays and state bytes; prints both walls and their launches."""
    from dst_libp2p_test_node_tpu_torch.native import tuned
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _config4_cfg()
    os.environ.pop("DST_TUNED_JSON", None)
    tuned.invalidate_cache()
    sim = Simulator(cfg, device=dev)
    sim.warmup()
    s0 = sim.state
    rng0 = sim._msg_rng.bit_generator.state

    def publish(with_table):
        if with_table:
            os.environ["DST_TUNED_JSON"] = table
        else:
            os.environ.pop("DST_TUNED_JSON", None)
        tuned.invalidate_cache()
        sim.state = dataclasses.replace(
            s0, **{f.name: getattr(s0, f.name).clone()
                   for f in dataclasses.fields(s0)})
        sim._msg_rng.bit_generator.state = rng0
        sim.records = []
        torch.cuda.synchronize()
        g0 = vg.launches
        t0 = time.time()
        rec = sim.publish(cfg.publisher_id)
        torch.cuda.synchronize()
        return rec, sim.state, time.time() - t0, vg.launches - g0

    try:
        publish(False)                                     # warm
        with_t = publish(True)
        without = publish(False)
    finally:
        os.environ.pop("DST_TUNED_JSON", None)
        tuned.invalidate_cache()
    _same_records("13(c) config 4 publish with the tuned table",
                  [without[0]], [with_t[0]])
    _same_state("13(c) config 4 publish with the tuned table", without[1],
                with_t[1])
    check(with_t[3] > 0, "13(c): the publish never launched vmem_gather")
    with open(table) as f:
        installed = json.load(f)
    print(f"[tooling] 13(c) config 4 exact publish ({EXACT_N} peers x 4 "
          f"fragments) with the table {installed}: {with_t[2]:.3f} s, "
          f"{with_t[3]} gathers; without: {without[2]:.3f} s, {without[3]} "
          f"gathers; delays and state the same bytes")


MICROBENCH13D_JSON = os.path.join(SCRATCH, "microbench13d.json")


def microbench13d_start():
    """13(d)'s `microbench` process, started early (side_start, beside
    10(a)) without a tuning table and with one intra-op thread."""
    env = {k: v for k, v in os.environ.items() if k != "DST_TUNED_JSON"}
    env["OMP_NUM_THREADS"] = "1"
    side_start("microbench13d", port_cmd(
        "microbench", "--no-sweep", "--only", "disseminate/cold", "--out",
        MICROBENCH13D_JSON), env=env)


def phase_tooling_cli(dev):
    """13(d): `microbench --no-sweep --only disseminate/cold` as a process
    on the card (run beside 10(a)): its strict-JSON artifact (the cold
    publish's roofline and the packed A/B at 100,000 peers). 13(d)'s
    `lint` process is 17(c)'s since phase 17 joined."""
    proc, wall = side_wait("microbench13d")
    check(proc.returncode == 0, f"13(d) microbench exited "
          f"{proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    mb = _strict_json(MICROBENCH13D_JSON)
    check(sorted(mb["rooflines"]) == ["disseminate/cold"],
          f"13(d) microbench rooflines {sorted(mb['rooflines'])}")
    ab = mb["packed_state_ab"]
    print(f"[tooling] 13(d) microbench --no-sweep --only disseminate/cold: "
          f"exit 0 in {wall:.1f} s beside 10(a) on {mb['device_name']}; "
          f"packed A/B "
          f"at {ab['n_peers']} peers: off {ab['publish_off_s']:.4f} s, on "
          f"{ab['publish_on_s']:.4f} s, receiver side {ab['receiver_side']},"
          f" op logs identical {ab['op_log_identical']}, launch logs "
          f"identical {ab['launch_log_identical']} (records off / off again "
          f"/ on {ab['launch_records']}, repeatable "
          f"{ab['launch_log_repeatable']}), program_identical "
          f"{ab['program_identical']}, delays identical "
          f"{ab['delays_identical']}")
    check(ab["delays_identical"] or not ab["program_identical"],
          "13(d) packed A/B: the same program gave other delays")


def phase_13(dev, kernels):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    table = os.path.join(SCRATCH, "tuned13.json")
    phase_registry_parity(dev)
    launches = phase_microbench(dev, kernels, table)
    phase_tuned_publish(dev, table)
    phase_tooling_cli(dev)
    print(f"[tooling] phase 13 took {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 14

BACKOFF_N = 10_000
BACKOFF_MAX_FAILS = 20
# how often nvidia-smi samples the card's utilization during 14(b)
UTIL_SAMPLE_MS = 200


def phase_backoff(dev):
    """14(a): kad.evict_failed at max_fails 20 (the backoff through
    xlamath.exp2_f32 and one FMA) on a 10,000-peer DHT table, on the card
    and on the CPU: every leaf bitwise. The table is warmed on the card
    (two lookup waves), the fail counters preset over 0..19 and the clock
    fractional, so every backoff exponent, the inexact ones from 2^13 up
    included, is taken."""
    from dst_libp2p_test_node_tpu_torch import interop, prng
    from dst_libp2p_test_node_tpu_torch.ops import kad

    t0 = time.time()
    n = BACKOFF_N
    st = kad.init_kad_state(n, seed=6, device=dev)
    st = kad.seed_bootstraps(st, torch.arange(2, device=dev))
    key = prng.PRNGKey(6, device=dev)
    origins = torch.arange(2, n, device=dev)
    stage = torch.zeros(n, dtype=torch.int32, device=dev)
    lat = torch.full((1, 1), 10.0, device=dev)
    for _ in range(2):
        key, k = prng.split(key)
        _, st = kad.find_node(st, origins, kad.random_targets(k, n - 2),
                              stage, lat)
    q = torch.arange(2, min(n, 2002), device=dev)
    res, st = kad.find_node(st, q, st.keys[q], stage, lat)
    gen = np.random.default_rng(14)
    alive = np.ones(n, bool)
    alive[gen.choice(n, n // 20, replace=False)] = False
    found = res.closest.long().cpu()
    found[:, -3:] = torch.as_tensor(np.flatnonzero(~alive)[:3])
    leaves = interop.leaves_to_numpy(st)
    leaves.update(
        alive=alive,
        rt_fails=gen.integers(0, BACKOFF_MAX_FAILS, leaves["rt_fails"].shape
                              ).astype(leaves["rt_fails"].dtype),
        t_ms=np.asarray(1234.567, dtype=np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        sd = interop.dataclass_from_numpy(kad.KadState, leaves, d)
        out = kad.evict_failed(sd, q.to(d), found.to(d),
                               max_fails=BACKOFF_MAX_FAILS,
                               backoff_base_ms=37.3)
        outs.append(interop.leaves_to_numpy(out))
    bad = interop.leaf_mismatches(outs[1], outs[0])
    check(bad == [], f"14(a) evict_failed CUDA != CPU: {bad}")
    retry = outs[0]["rt_retry_ms"]
    hit = np.unique(outs[0]["rt_fails"][retry > 0])
    check(set(range(14, BACKOFF_MAX_FAILS)) <= set(hit.tolist()),
          f"14(a) backoff exponents taken: {hit.tolist()}")
    print(f"[grid] 14(a) evict_failed at max_fails {BACKOFF_MAX_FAILS} on a "
          f"{n}-peer table ({q.numel()} origins): CUDA = CPU on every leaf; "
          f"{int((retry > 0).sum())} entries under backoff, exponents "
          f"{hit.min() - 1}..{hit.max() - 1} ({time.time() - t0:.1f} s)")


class _UtilSampler:
    """nvidia-smi's utilization.gpu of card 0 sampled every UTIL_SAMPLE_MS
    while open: idle share = 1 - mean / 100."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", f"-lms={UTIL_SAMPLE_MS}",
             "-i", "0"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [float(x) for x in out.split()
                        if x.replace(".", "", 1).isdigit()]

    @property
    def idle_share(self) -> float:
        if not self.samples:
            return math.nan
        return 1.0 - sum(self.samples) / len(self.samples) / 100.0


# 14(b)'s trial grid, its ranks started beside 12(a) (grid14_start)
_GRID14: dict = {}


def grid14_start(dev):
    """Open 14(b)'s trial grid of two ranks on the card and start its
    ranks in a thread, beside 12(a); grid14_ready joins the start before
    the next timed part. The ranks then wait idle for 14(b)."""
    from dst_libp2p_test_node_tpu_torch.parallel.ranks import RankPool
    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        make_trial_mesh)

    pool = RankPool(make_trial_mesh(devices=[dev, dev]).group_devices)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    _GRID14.update(pool=pool, started=ex.submit(pool.start))
    ex.shutdown(wait=False)


def grid14_ready():
    """Wait for 14(b)'s ranks to report ready (grid14_start)."""
    t0 = time.time()
    _GRID14["started"].result()
    print(f"[grid] waited {time.time() - t0:.1f} s for 14(b)'s ranks after "
          f"12(a)")


def phase_grid(dev, res9c, launches9c):
    """14(b): 9(c)'s static-flood campaign (100k peers x 4 fragments,
    fractions 0 / 0.1, seeds 0 and 1, 20 + 10 heartbeats, recorder and
    checkpoints on, a fresh directory) with a trial grid of two ranks
    sharing the card (started beside 12(a)): every trial field equal to
    9(c)'s result outside the walls; the ranks' launches plus the
    caller's (the benign cell) equal to 9(c)'s, both kernels launched in
    each rank. Prints trials/s both ways, each rank's start-up seconds
    and the card's idle share over the grid run. Returns the launches."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    ck = os.path.join(SCRATCH, "grid14")
    shutil.rmtree(ck, ignore_errors=True)
    cfg = _campaign_cfg(CAMP_FULL_N, "sybil_graft_flood", (0.0, 0.1),
                        (0, 1), 20, EXACT_WARMUP_S, msg_size=15000, frags=4,
                        recovery=10, ckpt=ck)
    _GRID14.pop("started").result()
    with _GRID14.pop("pool") as pool:
        torch.cuda.synchronize()
        vg.launches = 0
        su.launches = 0
        with _UtilSampler() as util:
            res = run_campaign(cfg, trial_mesh=pool, device=dev)
            torch.cuda.synchronize()
        caller = {"vmem_gather": vg.launches, "score_update": su.launches}
        per_rank = [dict(r) for r in pool.launches]
        startup = list(pool.startup_s)
        rank_s = list(pool.seconds)
    ranks = {k: sum(r[k] for r in per_rank) for k in caller}
    check(_campaign_fields(res) == _campaign_fields(res9c),
          "14(b): the grid's campaign differs from 9(c)'s")
    for k in caller:
        check(caller[k] + ranks[k] == launches9c[k],
              f"14(b): {k} launches: caller {caller[k]} + ranks {ranks[k]}"
              f" != 9(c)'s {launches9c[k]}")
        for r, lr in enumerate(per_rank):
            check(lr[k] > 0, f"14(b): rank {r} never launched {k}")
    att = [w for w in res.phase_walls if w["fraction"] > 0]
    check(len(att) == 2 and not any(w["resumed"] for w in att),
          "14(b): the attacked trials did not run on the ranks")
    print(f"[grid] 14(b) {CAMP_FULL_N} peers x 4 fragments, 9(c)'s campaign "
          f"on a grid of 2 ranks sharing {torch.cuda.get_device_name(0)}: "
          f"every trial field = 9(c)'s; trials_per_s {res.trials_per_s:.4f} "
          f"(wall_s {res.wall_s:.3f}) against 9(c)'s "
          f"{res9c.trials_per_s:.4f} (wall_s {res9c.wall_s:.3f}); rank "
          f"start-up {', '.join(f'{x:.1f}' for x in startup)} s (beside "
          f"12(a)), rank job "
          f"{', '.join(f'{x:.1f}' for x in rank_s)} s; launches caller "
          f"{caller} + ranks {per_rank} = 9(c)'s {launches9c}; card idle "
          f"share {util.idle_share:.4f} over {len(util.samples)} samples "
          f"of nvidia-smi utilization.gpu every {UTIL_SAMPLE_MS} ms")
    for t, w in zip(res.to_dict()["trials"], res.phase_walls):
        walls = ", ".join(f"{k} {v:.3f} s" for k, v in w.items()
                          if k not in ("fraction", "seed", "resumed"))
        print(f"[grid] 14(b)   f={t['fraction']:g} s={t['seed']}: {walls}")
    return {"caller": caller, "ranks": ranks, "per_rank": per_rank}


DCN14_JSON = os.path.join(SCRATCH, "dcn14.json")


def dcn14_start():
    """14(c)'s scripts/dcn_campaign_torch.py, started early (side_start,
    beside 7(a)) with one intra-op thread a process: the merged and the
    single-process runs it compares both run under that setting."""
    os.makedirs(SCRATCH, exist_ok=True)
    side_start("dcn14", [
        sys.executable, os.path.join(ROOT, "scripts",
                                     "dcn_campaign_torch.py"),
        "--n", str(CAMP6_N), "--seeds", "2", "--workdir",
        os.path.join(SCRATCH, "dcn14"), "--out", DCN14_JSON, "--timeout",
        "600"], env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=900)


def phase_dcn(dev):
    """14(c): scripts/dcn_campaign_torch.py at config 6's 2,048 peers (run
    beside 7(a)): two torch.distributed processes on the card, each on
    its own one-group grid, merged, against the single-process campaign
    (the same seeds): bit_identical, and both walls."""
    proc, wall = side_wait("dcn14")
    check(proc.returncode == 0, f"14(c) dcn_campaign_torch exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    with open(DCN14_JSON) as f:
        r = json.load(f)
    check(r["bit_identical"] is True and r["trials"] == 4,
          f"14(c) DCN campaign: {r}")
    print(f"[grid] 14(c) DCN campaign at {r['network_size']} peers, "
          f"{r['nproc']} processes x {r['devs_per_proc']} group on the card: "
          f"merged = single-process outside the walls ({r['trials']} "
          f"trials); dcn {r['dcn_trials_per_s']:.4f} trials/s (wall "
          f"{r['dcn_wall_s']:.3f} s), single {r['single_trials_per_s']:.4f} "
          f"(wall {r['single_wall_s']:.3f} s) ({wall:.1f} s beside 7(a))")


GRID14D_JSON = os.path.join(SCRATCH, "camp6_grid.json")


def grid14d_start():
    """14(d)'s `attack --trial-groups 0` process, started early
    (side_start)."""
    side_start("grid14d", port_cmd(
        "attack", "-n", str(CAMP6_N), "--msg-size", "2000", "--connect-to",
        "10", "--warmup-s", "30", "--fractions", "0,0.1", "--seeds", "0,1",
        "--attack-heartbeats", "20", "--messages", "3", "--delay-s", "2",
        "--trial-groups", "0", "--json", GRID14D_JSON))


def phase_grid_cli(dev):
    """14(d): 9(b)'s `attack` process at 2,048 peers again with
    --trial-groups 0 (one group on one card, so the caller runs it; run
    beside 11(a)): its JSON equal to 9(b)'s outside the walls."""
    js = GRID14D_JSON
    proc, wall = side_wait("grid14d")
    check(proc.returncode == 0, f"14(d) attack --trial-groups 0 exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(js) as f:
        d_grid = json.load(f)
    with open(CAMP6_JSON) as f:
        d_9b = json.load(f)
    check(_strip_walls(d_grid) == _strip_walls(d_9b),
          "14(d): attack --trial-groups 0 differs from 9(b)'s artifact")
    print(f"[grid] 14(d) attack --trial-groups 0 at {CAMP6_N} peers (a "
          f"process, one group, beside 11(a)): JSON = 9(b)'s outside the "
          f"walls ({wall:.1f} s)")


def phase_14(dev, res9c, launches9c):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    phase_backoff(dev)
    launches = phase_grid(dev, res9c, launches9c)
    phase_dcn(dev)
    phase_grid_cli(dev)
    print(f"[grid] phase 14 took {time.time() - t0:.1f} s")
    return launches


# --------------------------------------------------------------- phase 15

# half of PARITY_N, to keep the whole smoke within its time line
MESH_PARITY_N = PARITY_N // 2
MESH_RANKS = 2


def _mesh_parity_cfg(n):
    """3b(a)'s gossip-heavy exact setting with tcp loss 5% and churn, on
    the serial engine (the refinement a mesh takes)."""
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    topo = TopoParams(network_size=n, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=2, messages=3,
                      delay_seconds=2.0, packet_loss=0.05)
    return ExperimentConfig(
        topo=topo, seed=3, warmup_s=30.0, answer_queue_mode="serial",
        churn_down_per_hb=0.005, churn_up_per_hb=0.0025,
        gossipsub=GossipSubParams(flood_publish=False, d_lazy=12))


def _rank_launch_delta(pool, before):
    return [{k: r[k] - b[k] for k in r} for r, b in zip(pool.launches,
                                                       before)]


def phase_mesh_parity(dev, mesh):
    """15(a): a Simulator on MESH_RANKS ranks sharing the card against the
    port's one-process CPU run at 1,024 peers (exact, 2 fragments, tcp
    loss 5%, churn, serial engine): latencies, shadowlog, summaries, every
    record field and every state leaf bitwise; both kernels launched in
    each rank. Then vmem_gather at a rank's shape (N/P rows of src against
    an N-long t) bitwise against its plain version, and timed at config
    4's 100k / 2 x 40 against a 100k t."""
    import copy

    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops.state import SimParams
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    t0 = time.time()
    cfg = _mesh_parity_cfg(MESH_PARITY_N)
    cpu = Simulator(copy.deepcopy(cfg), device="cpu")
    cpu.run()
    t1 = time.time()
    before = [dict(r) for r in mesh.pool.launches]
    sim = Simulator(cfg, mesh=mesh)
    sim.run()
    launches = _rank_launch_delta(mesh.pool, before)
    t2 = time.time()
    for what, a, b in zip(("latencies", "shadowlog", "summaries"),
                          _outputs(cpu), _outputs(sim)):
        check(a == b, f"15(a) mesh and one-process CPU {what} differ")
    _same_records("15(a) mesh records", cpu.records, sim.records)
    _same_state("15(a) mesh state", cpu.state, sim.state)
    for r, lr in enumerate(launches):
        for k, v in lr.items():
            check(v > 0, f"15(a): rank {r} never launched {k}")
    stats = sim.collectives()
    sim.close()
    print(f"[mesh] 15(a) {MESH_PARITY_N} peers x 2 fragments, exact "
          f"(serial engine), tcp 5%, churn: {MESH_RANKS} ranks on {dev} "
          f"({mesh.backend}) = the one-process CPU run on latencies, "
          f"shadowlog, summaries, every record field and state leaf "
          f"({t2 - t1:.1f} s; CPU {t1 - t0:.1f} s); rank launches "
          f"{launches}; all-gathers per rank "
          f"{[s['all_gather'] for s in stats]}")

    # the gather at a rank's shape: N/P rows of src, an N-long t
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}
    for n in (999, EXACT_N):
        rows = n // MESH_RANKS
        t, src = _gather_inputs(n, 40, gen, dev)
        src = src[n - rows:].contiguous()          # the last rank's rows
        got, want = vg.vmem_gather(t, src), vg.vmem_gather_ref(t, src)
        check(torch.equal(got, want),
              f"15(a) vmem_gather != plain at {rows}x40 rows, t {n}")
        if n == EXACT_N:
            ms, plain = paired_ms(lambda: vg.vmem_gather_ref(t, src),
                                  lambda: vg.vmem_gather(t, src))
            lib = cuda_ms(lambda: t[src.clamp_min(0)])
            b, by = bound_ms(src.numel() * 4 * 2 + t.numel() * 4)
            out = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                       library_ms=lib, max_abs_err=0.0, shape=[rows, 40],
                       t_len=n)
    print(f"[mesh] 15(a) vmem_gather bitwise at a rank's shape (999 // 2 "
          f"and {EXACT_N} // 2 rows x 40 against the whole t); at "
          f"{EXACT_N // MESH_RANKS}x40 against a {EXACT_N} t: "
          f"{out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms, "
          f"t[src.clamp_min(0)] {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})")

    # score_update on a rank's rows of config 4
    rows = EXACT_N // MESH_RANKS
    params = SimParams(n=rows, capacity=40, slow_weight=-10.0)
    fmd = torch.rand((rows, 40), generator=gen, device=dev) * 3.0
    slow = torch.rand((rows, 40), generator=gen, device=dev) * 0.5
    scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                          device=dev)
    got = su.score_update(fmd, slow, scales, params)
    want = su.score_update_ref(fmd, slow, scales, params)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-6),
          f"15(a) score_update != plain at {rows}x40")
    ms, plain = paired_ms(
        lambda: su.score_update_ref(fmd, slow, scales, params),
        lambda: su.score_update(fmd, slow, scales, params))
    b, by = bound_ms(fmd.numel() * 4 * 5 + 8, flops=fmd.numel() * 7.0)
    score = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                 library_ms=None, shape=[rows, 40],
                 max_abs_err=float((got[2] - want[2]).abs().max()))
    print(f"[mesh] 15(a) score_update at a rank's {rows}x40: counters "
          f"bitwise, {ms:.4f} ms vs plain {plain:.4f} ms, bound {b:.4f} ms "
          f"({by})")
    return {"vmem_gather": out, "score_update": score}


def phase_mesh_config4(dev, mesh, stats3b, launches3b):
    """15(b) and (c): BASELINE config 4 (phase 3b's experiment) on
    MESH_RANKS ranks sharing the card. (b) warm-up, message 1, a
    checkpoint, messages 2 and 3: latencies and shadowlog byte-identical
    to 3b's files, p50 / p99 / coverage / max equal to 3b's stats, each
    rank's launches equal to 3b's; prints wall and peer-rounds/s beside
    3b's, all-gathers and their bytes per publish, each rank's start-up
    and the card's idle share over the run. (c) the checkpoint's bytes
    equal to 6(b)'s one-process save at the same point, then 6(b)'s file
    loaded with mesh= and run to the end: 3b's latencies again."""
    from dst_libp2p_test_node_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _config4_cfg()
    pub = cfg.publisher_id % EXACT_N
    before = [dict(r) for r in mesh.pool.launches]
    torch.cuda.synchronize()
    gathers = []
    with _UtilSampler() as util:
        t0 = time.time()
        sim = Simulator(cfg, mesh=mesh)
        t_build = time.time() - t0
        sim.warmup()
        t_warm = time.time() - t0 - t_build

        def published():
            g0 = sim.collectives()[0]
            sim.publish(pub)
            g1 = sim.collectives()[0]
            gathers.append((g1["all_gather"] - g0["all_gather"],
                            g1["all_gather_bytes"] - g0["all_gather_bytes"]))

        published()
        t_pause = time.time()
        ck = os.path.join(SCRATCH, "mesh_config4.npz")
        save_checkpoint(sim, ck)
        t_save = time.time() - t_pause
        for _ in range(2):
            sim.advance(cfg.topo.delay_seconds * 1000.0)
            published()
        wall = time.time() - t0 - t_save
    launches = _rank_launch_delta(mesh.pool, before)
    prefix = os.path.join(SCRATCH, "mesh_")
    sim.write_latencies(prefix + "latencies1")
    sim.write_shadowlog(prefix + "shadowlog1")
    for f in ("latencies1", "shadowlog1"):
        check(_sha256(prefix + f) == _sha256(os.path.join(SCRATCH,
                                                          "exact_" + f)),
              f"15(b) the mesh's {f} differs from 3b's")
    s = sim.summary(True)
    delays = np.concatenate([r.delays_ms[r.received] for r in sim.records])
    got = {"coverage": s.coverage(), "max_latency_ms": s.max_latency_ms,
           "p50_ms": float(np.percentile(delays, 50)),
           "p99_ms": float(np.percentile(delays, 99)),
           "refine_passes": [r.refine_passes for r in sim.records],
           "converged": all(r.converged for r in sim.records)}
    for k, v in got.items():
        check(stats3b[k] == v, f"15(b) {k} {v} != 3b's {stats3b[k]}")
    for r, lr in enumerate(launches):
        check(lr == launches3b, f"15(b) rank {r} launches {lr} != 3b's "
              f"{launches3b}")
    prs = sim.peer_rounds_per_sec(wall)
    same_ck = _sha256(ck) == _sha256(os.path.join(SCRATCH, "config4.npz"))
    print(f"[mesh] 15(b) config 4 ({EXACT_N} peers x 4 fragments, exact, "
          f"churn {EXACT_CHURN}) on {MESH_RANKS} ranks sharing "
          f"{torch.cuda.get_device_name(0)} over {mesh.backend}: latencies1 "
          f"and shadowlog1 byte-identical to 3b's, p50 {got['p50_ms']:.3f} "
          f"p99 {got['p99_ms']:.3f} ms = 3b's; wall {wall:.3f} s (build "
          f"{t_build:.3f}, warm-up {t_warm:.3f}, checkpoint save {t_save:.3f} "
          f"apart), peer-rounds/s {prs:.1f}; 3b in one process: wall "
          f"{stats3b['wall_s']:.3f} s, peer-rounds/s "
          f"{stats3b['peer_rounds_per_sec']:.1f}; all-gathers per publish "
          f"per rank {[g for g, _ in gathers]}, their bytes "
          f"{[b for _, b in gathers]}; rank start-up "
          f"{', '.join(f'{x:.1f}' for x in mesh.pool.startup_s)} s, rank "
          f"build {', '.join(f'{x:.1f}' for x in sim.rank_build_s)} s; "
          f"launches per rank {launches} (3b: {launches3b}); peak "
          f"allocated per rank "
          f"{', '.join(f'{b / 2**30:.2f}' for b in sim.rank_peak_bytes)} "
          f"GiB (3b in one process: {stats3b['peak_bytes'] / 2**30:.2f} "
          f"GiB); card idle "
          f"share {util.idle_share:.4f} over {len(util.samples)} samples "
          f"of nvidia-smi utilization.gpu every {UTIL_SAMPLE_MS} ms")
    check(same_ck, "15(c) the mesh's checkpoint differs from 6(b)'s "
          "one-process save at the same point")
    sim.close()
    del sim
    t0 = time.time()
    back = load_checkpoint(os.path.join(SCRATCH, "config4.npz"), mesh=mesh)
    t_load = time.time() - t0
    back.run()
    back.write_latencies(prefix + "resumed_latencies1")
    check(_sha256(prefix + "resumed_latencies1")
          == _sha256(os.path.join(SCRATCH, "exact_latencies1")),
          "15(c) the resumed mesh run's latencies differ from 3b's")
    back.close()
    print(f"[mesh] 15(c) the mesh's checkpoint after message 1 = 6(b)'s "
          f"one-process file byte for byte ({os.path.getsize(ck) / 2**20:.1f} "
          f"MiB, saved in {t_save:.3f} s: one gather of the rows); 6(b)'s "
          f"file loaded with mesh= in {t_load:.3f} s and run to the end: "
          f"3b's latencies1 ({time.time() - t0:.1f} s)")
    return {"ranks": {k: sum(r[k] for r in launches) for k in launches3b},
            "per_rank": launches}


def dcn15d_start():
    """15(d)'s scripts/dcn_smoke_torch.py, started early (side_start)."""
    side_start("dcn15d", [sys.executable,
                          os.path.join(ROOT, "scripts", "dcn_smoke_torch.py")])


def phase_mesh_dcn(dev):
    """15(d): scripts/dcn_smoke_torch.py on the card (run beside 9(a)),
    its step 5 (one heartbeat and one disseminate on each process's rows
    of a 64-peer mesh over the two processes, checked against the
    one-process run)."""
    proc, wall = side_wait("dcn15d")
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0 and "PASS" in out
          and out.count("sharded==single-process OK") == 2,
          f"15(d) dcn_smoke_torch exited {proc.returncode}: {out[-2000:]}")
    rows = [ln.split("fixpoint rows=")[1].split(" sharded")[0]
            for ln in out.splitlines() if "fixpoint rows=" in ln]
    print(f"[mesh] 15(d) scripts/dcn_smoke_torch.py on the card: steps 1-5 "
          f"PASS, step 5's fixpoint rows {rows} = the one-process run "
          f"({wall:.1f} s beside 9(a))")


def phase_15(dev, mesh, stats3b, launches3b):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    check(mesh.backend == "gloo", f"two ranks on one card took "
          f"{mesh.backend}")
    timed = phase_mesh_parity(dev, mesh)
    launches = phase_mesh_config4(dev, mesh, stats3b, launches3b)
    phase_mesh_dcn(dev)
    print(f"[mesh] phase 15 took {time.time() - t0:.1f} s")
    return dict(launches, timed=timed)


# --------------------------------------------------------------- phase 16

# 16(a)'s grid: GRID16 trial groups, each GRID16 ranks wide, on the card
GRID16 = 2
# 16(a)'s recovery rounds: half of 10(a)'s 8, for phase 16's 60 s aim
GRID16_RECOVERY = 4
# 16(c)'s network and warm-up (a third of 15(a)'s 30 s, for the same aim)
RECORDER16_N = PARITY_N
RECORDER16_WARMUP_S = 10.0


def _grid16_cases():
    """16(a)'s two campaigns at 10(a)'s shape: 10(a)'s composed fault
    schedule with the adaptive attacker and a recovery window, and 10(a)'s
    DHT two-leg campaign (both with GRID16_RECOVERY recovery rounds)."""
    return {
        "composed_adaptive": dict(
            scenario="sybil_graft_flood", adaptive=True,
            recovery=GRID16_RECOVERY,
            faults=dict(FAULTS10, crash_frac=0.1, partition_window=(4, 40))),
        "dht": dict(scenario="eclipse_publisher", recovery=GRID16_RECOVERY,
                    dht=dict(lookup_eclipse=True, rtable_poison=True,
                             sybil_cluster=True, heal_hb=3)),
    }


def _grid16_runs(dev, pool):
    """16(a)'s three runs on `pool` (the grid; None: the one-process CPU
    run): {tag: (CampaignResult, checkpoint dir)} and the arena's artifact
    under "arena" (wall_s dropped)."""
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        run_arena_campaign, run_campaign)

    device = dev if pool is not None else torch.device("cpu")
    common = dict(fractions=(0.0, 0.2), seeds=(0, 1), attack_hb=10,
                  warmup_s=5.0, anchor_stages=3)
    out = {}
    for tag, kw in _grid16_cases().items():
        ck = os.path.join(SCRATCH, f"camp16a_{tag}_{int(pool is None)}")
        shutil.rmtree(ck, ignore_errors=True)
        cfg = _cfg10(CAMP_PARITY_N, ckpt=ck, **common, **kw)
        out[tag] = (run_campaign(cfg, trial_mesh=pool, device=device), ck)
    cfg = _arena_cfg(_exp11(ARENA_PARITY_N, 2000, 1, 8.0, messages=2,
                            delay_s=0.5, anchor_stages=3), (0, 1), 6,
                     FAULTS11)
    out["arena"] = run_arena_campaign(cfg, trial_mesh=pool, device=device)
    out["arena"].pop("wall_s")
    return out


def phase_grid16(dev, pool, on_cpu):
    """16(a): one 2 x 2 grid (4 ranks sharing the card over gloo, each
    trial's 128 peer rows split over its group's two ranks) against the
    port's one-process CPU runs `on_cpu` of the same configs: the two
    campaigns of _grid16_cases (fractions 0 and 0.2, seeds 0 and 1, the
    recorder and checkpoints on) with every TrialResult field outside the
    walls, every checkpoint file and obs sidecar bitwise; run_arena_
    campaign with 11(a)'s faults, its artifact equal outside wall_s.
    Returns each rank's launches."""
    t0 = time.time()
    on_grid = _grid16_runs(dev, pool)
    summary = []
    for tag in _grid16_cases():
        (rg, ckg), (rc, ckc) = on_grid[tag], on_cpu[tag]
        check(_campaign_fields(rg) == _campaign_fields(rc),
              f"16(a) {tag}: the grid's TrialResults differ from the CPU "
              "run's")
        _same_npz_dirs(f"16(a) {tag}", ckg, ckc)
        att = [w for w in rg.phase_walls if w["fraction"] > 0]
        check(len(att) == 2 and all("all_gathers" in w for w in att),
              f"16(a) {tag}: the attacked trials did not run on the grid's "
              "ranks")
        summary.append(f"{tag}: coverage " + ", ".join(
            f"{t.honest_coverage:.4f}" for t in rg.trials if t.fraction > 0))
    check(on_grid["arena"] == on_cpu["arena"],
          "16(a) the grid's faulted arena differs from the CPU run's")
    launches = [dict(r) for r in pool.launches]
    print(f"[mesh16] 16(a) a {GRID16} x {GRID16} grid of 4 ranks sharing "
          f"the card (gloo), each trial's {CAMP_PARITY_N} rows over "
          f"{GRID16} ranks: the composed-fault adaptive campaign with "
          f"recovery, the DHT two-leg campaign and the faulted arena = the "
          f"one-process CPU runs in every field, checkpoint file and obs "
          f"sidecar ({time.time() - t0:.1f} s on the grid; rank start-up "
          f"{', '.join(f'{x:.1f}' for x in pool.startup_s)} s); launches "
          f"per rank {launches}; " + "; ".join(summary))
    return launches


def _gathers16(walls, phase, per=1):
    count, nbytes = walls.get("all_gathers", {}).get(phase, (0, 0))
    return f"{count / per:g} ({nbytes / per / 2**20:.1f} MiB)"


def phase_campaign_mesh16(dev, mesh, res9c, peak9c):
    """16(b): run_campaign(cfg, mesh=) on phase 15's 2 ranks at 9(c)'s
    network and full width (100,000 peers x 4 fragments of 15,000 B,
    exact, a 60 s warm-up, 20 attack + 10 recovery heartbeats, evict + px
    + redial, recorder and checkpoints on) for fraction 0.1, seed 0: the
    trial equal to 9(c)'s (0.1, 0) trial outside the walls, its
    checkpoint and obs sidecar byte for byte 9(c)'s, both kernels
    launched in each rank and equally often. Prints the wall and the
    walls by phase beside 9(c)'s, the all-gathers and their bytes per
    window and per publish, each rank's peak allocated memory beside
    9(c)'s and the card's idle share. Returns each rank's launches."""
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    ck = os.path.join(SCRATCH, "camp16b")
    shutil.rmtree(ck, ignore_errors=True)
    cfg = _campaign_cfg(CAMP_FULL_N, "sybil_graft_flood", (0.1,), (0,), 20,
                        EXACT_WARMUP_S, msg_size=15000, frags=4,
                        recovery=10, ckpt=ck)
    before = [dict(r) for r in mesh.pool.launches]
    torch.cuda.synchronize()
    with _UtilSampler() as util:
        t0 = time.time()
        res = run_campaign(cfg, mesh=mesh, device=dev)
        wall = time.time() - t0
    launches = _rank_launch_delta(mesh.pool, before)
    cell = (0.1, 0)
    want = [t for t in _campaign_fields(res9c)["trials"]
            if (t["fraction"], t["seed"]) == cell]
    got = _campaign_fields(res)["trials"]
    check(len(want) == 1 and got == want,
          f"16(b): the mesh's trial differs from 9(c)'s: {got} != {want}")
    for name in ("sybil_graft_flood_f0.1_s0.npz",
                 "sybil_graft_flood_f0.1_s0.obs.npz"):
        check(_sha256(os.path.join(ck, name))
              == _sha256(os.path.join(SCRATCH, "camp9c", name)),
              f"16(b): {name} differs from 9(c)'s file")
    for k in ("vmem_gather", "score_update"):
        check(all(lr[k] > 0 for lr in launches),
              f"16(b): a rank never launched {k}: {launches}")
        check(len({lr[k] for lr in launches}) == 1,
              f"16(b): the ranks launched {k} unequally: {launches}")
    walls = res.phase_walls[0]
    walls9c = [w for w in res9c.phase_walls
               if (w["fraction"], w["seed"]) == cell][0]
    trial9c = [t for t in res9c.trials if (t.fraction, t.seed) == cell][0]
    peaks = res.rank_stats["rank_peak_bytes"]
    print(f"[mesh16] 16(b) 9(c)'s campaign at fraction 0.1, seed 0 on "
          f"{len(mesh.devices)} ranks sharing "
          f"{torch.cuda.get_device_name(0)} ({CAMP_FULL_N} peers x 4 "
          f"fragments, 20 attack + 10 recovery heartbeats, recorder and "
          f"checkpoints on): the trial = 9(c)'s outside the walls, its "
          f"checkpoint and obs sidecar = 9(c)'s files; wall {wall:.3f} s, "
          f"the trial's wall_s {res.trials[0].wall_s:.3f} against 9(c)'s "
          f"{trial9c.wall_s:.3f}; launches per rank {launches}; "
          f"all-gathers per rank: attack window "
          f"{_gathers16(walls, 'attack_window')}, recovery window "
          f"{_gathers16(walls, 'recovery_window')}, per publish "
          f"{_gathers16(walls, 'publish', cfg.experiment.topo.messages)}; "
          f"peak allocated per rank "
          f"{', '.join(f'{(b or 0) / 2**30:.2f}' for b in peaks)} GiB (9(c) in "
          f"one process: {peak9c / 2**30:.2f} GiB); card idle share "
          f"{util.idle_share:.4f} over {len(util.samples)} samples of "
          f"nvidia-smi utilization.gpu every {UTIL_SAMPLE_MS} ms")
    skip = ("fraction", "seed", "resumed", "all_gathers")
    print("[mesh16] 16(b)   walls: " + ", ".join(
        f"{k} {v:.3f} s (9(c) {walls9c.get(k, 0.0):.3f})"
        for k, v in walls.items() if k not in skip))
    print("[mesh16] 16(b)   all-gathers by phase per rank: " + ", ".join(
        f"{k} {c} ({b / 2**20:.1f} MiB)"
        for k, (c, b) in walls.get("all_gathers", {}).items()))
    return launches


def phase_recorder16(dev, mesh):
    """16(c): the flight recorder on a 2-rank ShardedSimulator at 2,048
    peers (15(a)'s setting: exact, 2 fragments, tcp loss 5%, churn; a
    10 s warm-up): record_telemetry and the warm-up, then fractional byte
    counters and uplink backlogs planted in every row (what publishes
    leave) and 2.5 s of heartbeats; every last_telemetry curve bitwise the
    one-process CPU run's."""
    import copy

    from dst_libp2p_test_node_tpu_torch import interop
    from dst_libp2p_test_node_tpu_torch.ops.telemetry import TelemetryParams
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    t0 = time.time()
    n = RECORDER16_N
    cfg = dataclasses.replace(_mesh_parity_cfg(n),
                              warmup_s=RECORDER16_WARMUP_S)
    gen = np.random.default_rng(16)
    planted = {k: gen.uniform(0, 3e5, n).astype(np.float32)
               for k in ("bytes_tx", "bytes_rx")}
    planted["uplink_free_ms"] = (RECORDER16_WARMUP_S * 1000.0 + gen.uniform(
        0, 5000, n)).astype(np.float32)
    curves = []
    for sim in (Simulator(copy.deepcopy(cfg), device="cpu"),
                Simulator(cfg, mesh=mesh)):
        sim.record_telemetry(TelemetryParams(record=True))
        sim.warmup()
        warm = dict(sim.last_telemetry)
        leaves = interop.state_to_numpy(sim.state)
        sim.state = interop.state_from_numpy(dict(leaves, **planted), "cpu")
        sim.advance(2500.0)
        curves.append((warm, dict(sim.last_telemetry)))
        if sim.mesh is not None:
            sim.close()
    for i, what in enumerate(("warm-up", "after the planted counters")):
        want, got = curves[0][i], curves[1][i]
        bad = interop.leaf_mismatches(want, got) + sorted(set(want)
                                                          ^ set(got))
        check(want and not bad, f"16(c) recorder {what}: {bad} differ")
    check(float(curves[1][1]["tel_queue_depth_ms"][0]) > 0.0,
          "16(c): the planted backlog left no queue depth")
    print(f"[mesh16] 16(c) record_telemetry on {len(mesh.devices)} ranks at "
          f"{n} peers = the one-process CPU run on every channel "
          f"({len(curves[0][0])} curves of "
          f"{len(curves[0][0]['tel_mesh_coverage'])} heartbeats, then "
          f"{len(curves[0][1]['tel_mesh_coverage'])}) "
          f"({time.time() - t0:.1f} s)")


def phase_16(dev, mesh, res9c, peak9c):
    from dst_libp2p_test_node_tpu_torch.parallel.ranks import RankPool

    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    pool = RankPool([dev] * (GRID16 * GRID16), peer_width=GRID16)
    with pool, concurrent.futures.ThreadPoolExecutor(1) as ex:
        # 16(a)'s ranks start while its CPU runs and 16(c) go
        started = ex.submit(pool.start)
        on_cpu = _grid16_runs(dev, None)
        phase_recorder16(dev, mesh)
        started.result()
        grid = phase_grid16(dev, pool, on_cpu)
    launches = phase_campaign_mesh16(dev, mesh, res9c, peak9c)
    print(f"[mesh16] phase 16 took {time.time() - t0:.1f} s")
    return {"ranks": {k: sum(r[k] for r in launches)
                      for k in launches[0]},
            "per_rank": launches, "grid": grid}


# ---------------------------------------------------------------- phase 17

MIX17_N = PARITY_N
MIX17_PUB = 1500            # on rank 1; the 128 mix nodes are rank 0's rows
RUNG17_FILE = "RUNG_1M_torch.json"


def _mix17_cfg(n, pub, warmup_s, args=None):
    """Config 5's relay (NUMMIX 128, MIXD 4, bounded, 15 KB, 2 messages)
    at n peers from `pub`; with `args` config 5 itself, built as `run`
    builds it (phase 4b's twin without warm_start)."""
    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.config.env import (
        gossipsub_params_from_env)
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    if args is not None:
        topo = _topo_from_fields(dict(zip(RUN_SH_PARAMS, args)))
    else:
        topo = TopoParams(network_size=n, anchor_stages=5, min_bandwidth=50,
                          max_bandwidth=150, min_latency=40,
                          max_latency=130, msg_size_bytes=15000,
                          messages=2, delay_seconds=2.0)
    return ExperimentConfig(
        topo=topo, gossipsub=gossipsub_params_from_env(), publisher_id=pub,
        warmup_s=warmup_s, seed=0, uses_mix=True, num_mix=128, mix_d=4,
        serialize_answers=False)


def phase_mix_parity17(dev, mesh):
    """17(a): the mix relay on MESH_RANKS ranks at 2,048 peers (config 5's
    relay, the publisher on rank 1, the mix nodes on rank 0) on the card,
    the same on 2 CPU ranks and in one CUDA process: latencies, records
    and every gathered state leaf byte for byte."""
    import copy

    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        make_peer_mesh)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _mix17_cfg(MIX17_N, MIX17_PUB, 10.0)
    t0 = time.time()
    one = Simulator(copy.deepcopy(cfg), device=dev)
    one.run()
    t1 = time.time()
    sims = {}
    with make_peer_mesh(devices=["cpu"] * MESH_RANKS) as cpu_mesh:
        for tag, m in (("cuda", mesh), ("cpu", cpu_mesh)):
            sim = Simulator(copy.deepcopy(cfg), mesh=m)
            sim.run()
            sims[tag] = (_outputs(sim)[0], sim.records, sim.state,
                         sim.collectives())
            sim.close()
    t2 = time.time()
    want = (_outputs(one)[0], one.records, one.state)
    for tag, (text, records, state, _) in sims.items():
        check(text == want[0], f"17(a) the {tag} mesh's latencies differ "
              "from the one-process CUDA run's")
        _same_records(f"17(a) {tag} mesh records", want[1], records)
        _same_state(f"17(a) {tag} mesh state", want[2], state)
    stats = sims["cuda"][3]
    print(f"[mesh17] 17(a) the mix relay at {MIX17_N} peers (NUMMIX 128, "
          f"MIXD 4, bounded, 2 messages from {MIX17_PUB}): {MESH_RANKS} "
          f"ranks on {dev} = {MESH_RANKS} CPU ranks = one CUDA process on "
          f"latencies, every record field and state leaf ({t2 - t1:.1f} s "
          f"for both meshes; one process {t1 - t0:.1f} s); broadcasts per "
          f"rank {[x['broadcast'] for x in stats]}, all-gathers "
          f"{[x['all_gather'] for x in stats]}")


def phase_config5_mesh17(dev, mesh, main5):
    """17(b): BASELINE config 5 (1M peers, NUMMIX 128, MIXD 4, bounded,
    15 KB, 2 messages, a 30 s warm-up) on MESH_RANKS ranks sharing the
    card, built as `run` builds it: latencies1 = phase 4's digest, each
    rank's launches = phase 4's. Prints the wall beside phase 4's,
    all-gathers and bytes per publish per rank, each rank's peak beside
    phase 4's, the card's idle share, the mix delay per message and the
    launches per rank."""
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    cfg = _mix17_cfg(FULL_N, 132, FULL_WARMUP_S, C5_ARGS)
    pub = cfg.publisher_id % FULL_N
    before = [dict(r) for r in mesh.pool.launches]
    gathers, walls = [], []
    torch.cuda.synchronize()
    with _UtilSampler() as util, publish_recorder() as rec:
        t0 = time.time()
        sim = Simulator(cfg, mesh=mesh)
        t_build = time.time() - t0
        sim.warmup()
        t_warm = time.time() - t0 - t_build
        for i in range(cfg.topo.messages):
            if i:
                sim.advance(cfg.topo.delay_seconds * 1000.0)
            g0 = sim.collectives()[0]
            sim.publish(pub)
            g1 = sim.collectives()[0]
            gathers.append((g1["all_gather"] - g0["all_gather"],
                            g1["all_gather_bytes"] - g0["all_gather_bytes"]))
        wall = time.time() - t0
    launches = _rank_launch_delta(mesh.pool, before)
    path = os.path.join(SCRATCH, "mesh17_latencies1")
    sim.write_latencies(path)
    same = _sha256(path) == main5["digest"]
    peaks = sim.rank_peak_bytes
    sim.close()
    print(f"[mesh17] 17(b) config 5 ({FULL_N} peers, NUMMIX 128, MIXD 4, "
          f"bounded) on {MESH_RANKS} ranks sharing "
          f"{torch.cuda.get_device_name(0)}: latencies1 = phase 4's: {same};"
          f" wall {wall:.3f} s (build {t_build:.3f}, warm-up {t_warm:.3f}, "
          f"publish walls {[round(w, 4) for w in rec['walls']]}) against "
          f"phase 4's {main5['wall_s']:.3f} s (simulation) and publish walls"
          f" {[round(w, 4) for w in main5['walls']]}; mix delay per message "
          f"{rec['mix_ms']} ms (phase 4: {main5['mix_ms']}); all-gathers per "
          f"publish per rank {[g for g, _ in gathers]}, their bytes "
          f"{[b for _, b in gathers]}; launches per rank {launches} (phase "
          f"4: {main5['launches']}); peak allocated per rank "
          f"{', '.join(f'{b / 2**30:.2f}' for b in peaks)} GiB (phase 4 in "
          f"one process: {main5['peak'] / 2**30:.2f} GiB); card idle share "
          f"{util.idle_share:.4f} over {len(util.samples)} samples")
    check(same, "17(b) the mesh's config-5 latencies1 differ from phase 4's")
    check(rec["mix_ms"] == main5["mix_ms"],
          f"17(b) mix delays {rec['mix_ms']} != phase 4's {main5['mix_ms']}")
    for r, lr in enumerate(launches):
        check(lr == main5["launches"], f"17(b) rank {r} launches {lr} != "
              f"phase 4's {main5['launches']}")
        for k, v in lr.items():
            check(v > 0, f"17(b) rank {r} never launched {k}")
    return launches


def phase_rank_kernels17(dev):
    """Both kernels at a rank's shape of 17(b): vmem_gather on 500k x 40
    rows of src against the whole 1M t, score_update on 500k x 40, each
    against its plain version (bitwise / rtol 1e-5) and timed."""
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops.state import SimParams

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = FULL_N // MESH_RANKS
    t, src = _gather_inputs(FULL_N, 40, gen, dev)
    src = src[FULL_N - rows:].contiguous()         # the last rank's rows
    got, want = vg.vmem_gather(t, src), vg.vmem_gather_ref(t, src)
    check(torch.equal(got, want),
          f"17 vmem_gather != plain at {rows}x40 rows, t {FULL_N}")
    ms, plain = paired_ms(lambda: vg.vmem_gather_ref(t, src),
                          lambda: vg.vmem_gather(t, src))
    lib = cuda_ms(lambda: t[src.clamp_min(0)])
    b, by = bound_ms(src.numel() * 4 * 2 + t.numel() * 4)
    gather = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                  library_ms=lib, max_abs_err=0.0, shape=[rows, 40],
                  t_len=FULL_N)
    del got, want, t, src
    params = SimParams(n=rows, capacity=40, slow_weight=-10.0)
    fmd = torch.rand((rows, 40), generator=gen, device=dev) * 3.0
    slow = torch.rand((rows, 40), generator=gen, device=dev) * 0.5
    scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                          device=dev)
    got = su.score_update(fmd, slow, scales, params)
    want = su.score_update_ref(fmd, slow, scales, params)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-6),
          f"17 score_update != plain at {rows}x40")
    sms, splain = paired_ms(
        lambda: su.score_update_ref(fmd, slow, scales, params),
        lambda: su.score_update(fmd, slow, scales, params))
    sb, sby = bound_ms(fmd.numel() * 4 * 5 + 8, flops=fmd.numel() * 7.0)
    score = dict(ms=sms, plain_ms=splain, bound_ms=sb, bound_by=sby,
                 library_ms=None, shape=[rows, 40],
                 max_abs_err=float((got[2] - want[2]).abs().max()))
    print(f"[mesh17] at a rank's shape of 17(b): vmem_gather {rows}x40 "
          f"against a {FULL_N} t bitwise, {ms:.4f} ms vs plain "
          f"{plain:.4f} ms, t[src.clamp_min(0)] {lib:.4f} ms, bound "
          f"{b:.4f} ms ({by}); score_update {rows}x40: counters bitwise, "
          f"{sms:.4f} ms vs plain {splain:.4f} ms, bound {sb:.4f} ms ({sby})")
    return {"vmem_gather": gather, "score_update": score}


LINT17_REPORT = os.path.join(SCRATCH, "lint17.json")
LINT17_CERT = os.path.join(SCRATCH, "rung17.json")


def lint17_start():
    """17(c, d)'s `lint` process, started early (side_start)."""
    env = {k: v for k, v in os.environ.items() if k != "DST_TUNED_JSON"}
    side_start("lint17", port_cmd(
        "lint", "--sharding", "--predict-rung", "--rung-out", LINT17_CERT,
        "--out", LINT17_REPORT, "--format", "github"), env=env, timeout=900)


def phase_lint17(dev):
    """17(c) and (d): `lint --sharding --predict-rung --rung-out` as one
    process on the card (13(d)'s lint folded in; run beside 12(a)): exit
    0, clean, 26 entry
    points, exactly the legacy layout's two GA-S001 waivers, zero
    cross-block bytes in the dcn contract; each mesh contract's
    collectives and each rank's peak. The certificate's verdict and every
    leaf's argument fit equal the committed RUNG_1M_torch.json, within
    10%; the modeled HBM equals the card's."""
    from dst_libp2p_test_node_tpu_torch.analysis import sharding_audit as sa

    report, cert_path = LINT17_REPORT, LINT17_CERT
    proc, wall = side_wait("lint17")
    check(proc.returncode == 0, f"17(c) lint exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    rep = _strict_json(report)
    check(rep["clean"] is True and rep["checked_entrypoints"] == 26,
          f"17(c) lint: clean {rep['clean']}, "
          f"{rep['checked_entrypoints']} entry points")
    waived = sorted((w["entrypoint"], w["rule"], w["message"].split()[1])
                    for w in rep["waived"])
    check(waived == [("campaign/attack_window_sharded", "GA-S001",
                      "shared.conns"),
                     ("campaign/attack_window_sharded", "GA-S001",
                      "shared.rev")], f"17(c) waived {waived}")
    sh = rep["sharding"]
    scope = sh["campaign/attack_window_dcn"]["collective_bytes_by_scope"]
    check(scope["cross_dcn"] == 0, f"17(c) cross-block bytes {scope}")
    for name, f in sorted(sh.items()):
        if f["ranks"] > 1:
            kinds = {k: (c["count"], c["per_rank_bytes"])
                     for k, c in f["collectives"].items()}
            print(f"[mesh17] 17(c) {name}: collectives (count, bytes on a "
                  f"rank) {kinds}; rank peaks "
                  f"{f['memory']['rank_peak_bytes']} B")
            check(f["memory"]["peak_measured"],
                  f"17(c) {name}: no rank peak measured on the card")
    cert = _strict_json(cert_path)
    with open(os.path.join(ROOT, RUNG17_FILE)) as fh:
        kept = json.load(fh)

    def fits(c):
        return {x["name"]: (x["coeff"], x["exponent"],
                            x["predicted_global_bytes"],
                            x["predicted_per_device_bytes"])
                for x in c["leaves"]}

    total = torch.cuda.get_device_properties(0).total_memory
    pred = cert["predicted_per_device"]["total"]
    print(f"[mesh17] 17(c, d) lint --sharding --predict-rung: exit 0 in "
          f"{wall:.1f} s beside 12(a), clean, {rep['checked_files']} files, "
          f"{rep['checked_entrypoints']} entry points, waived {waived}; "
          f"dcn scope {scope}; rung {cert['rung']['peers']} peers on "
          f"{cert['modeled_device']['name']}: held-out rel_err "
          f"{cert['validation']['rel_err']} at "
          f"{cert['validation']['peers']} peers, predicted "
          f"{pred / 2**30:.3f} GiB a GPU ({pred / total:.4f} of the card's "
          f"{total} B), verdict {cert['verdict']}, measured on "
          f"{cert['measured_on']}; fit points (peers, temp B) "
          f"{[(p['peers'], p['temp']) for p in cert['fit_points']]}")
    check(sa.H100_HBM_BYTES == total, f"17(d) the modeled HBM "
          f"{sa.H100_HBM_BYTES} B != the card's {total} B")
    check(cert["validation"]["within_10pct"], "17(d) the held-out fit "
          f"is off by {cert['validation']['rel_err']}")
    check(cert["verdict"] == kept["verdict"] and fits(cert) == fits(kept),
          f"17(d) the certificate's verdict or argument fits differ from "
          f"{RUNG17_FILE}")


def phase_17(dev, mesh, main5):
    t0 = time.time()
    os.makedirs(SCRATCH, exist_ok=True)
    phase_mix_parity17(dev, mesh)
    launches = phase_config5_mesh17(dev, mesh, main5)
    timed = phase_rank_kernels17(dev)
    phase_lint17(dev)
    print(f"[mesh17] phase 17 took {time.time() - t0:.1f} s")
    return {"ranks": {k: sum(r[k] for r in launches) for k in launches[0]},
            "per_rank": launches, "timed": timed}


# ---------------------------------------------------------------- phase 18

# 18(a): the validity twins at their scripts' full shapes, each against
# the reference's committed artifact: (twin script, artifact under docs/,
# the keys compared; None = every key of the artifact)
VALIDITY18 = (
    ("eth_anchor_torch.py", "VALIDITY_ANCHOR.json", None),
    ("attestation_anchor_torch.py", "VALIDITY_ANCHOR2.json", None),
    ("loss_modes_ab_torch.py", "LOSS_MODES.json", None),
    ("muxer_sensitivity_torch.py", "event_loop_calibration.json",
     ("muxer_sensitivity",)),
)
# the twins whose every run is benign gossip with heartbeats: each advance
# reaches score_update
ANCHORS18 = ("eth_anchor_torch.py", "attestation_anchor_torch.py")
# 18(b): scripts/service_load_torch.py at its docstring's chaos shape
SVC18_ARGS = ("--peers", "48", "--subnets", "2", "--ticks", "12",
              "--per-tick", "4", "--max-batch", "2", "--queue-depth", "4",
              "--inject-failures", "1", "--retry-backoff-s", "0",
              "--kill-at-tick", "6", "--checkpoint-every", "2", "--no-http")
# the report's keys that come from the simulation and the admission
# sequence (tests/port/test_torch_traffic.py's _SIM_KEYS)
SVC18_SIM_KEYS = ("config", "offered", "admitted", "rejected",
                  "shed_deadline", "dispatched", "quarantined", "retries",
                  "batch_splits", "device_dispatches", "degraded",
                  "shed_rate", "max_depth_seen", "queue_bound_held",
                  "records_sha", "scrape", "kill")


def _out18(name):
    return os.path.join(SCRATCH, f"validity18_{name}")


def _cmds18():
    """Phase 18's six processes by name: the four validity twins with
    --write into the scratch directory, and the service-load twin on CUDA
    and with --device cpu."""
    cmds = {script: [sys.executable, os.path.join(ROOT, "scripts", script),
                     "--write", _out18(script + ".json")]
            for script, _artifact, _keys in VALIDITY18}
    for dev in ("cuda", "cpu"):
        cmds[f"service_load_torch.py/{dev}"] = [
            sys.executable, os.path.join(ROOT, "scripts",
                                         "service_load_torch.py"),
            *SVC18_ARGS, "--device", dev,
            "--checkpoint", _out18(f"svc_{dev}.npz"),
            "--json", _out18(f"svc_{dev}.json")]
    return cmds


# phase 18's processes in two groups, each started beside a CUDA = CPU
# check that times nothing and waited for before the next timed part:
# beside 3 and 3b(a), and beside 6(c) and 3c
VALIDITY18_A = ("eth_anchor_torch.py", "attestation_anchor_torch.py",
                "muxer_sensitivity_torch.py")
VALIDITY18_B = ("loss_modes_ab_torch.py", "service_load_torch.py/cuda",
                "service_load_torch.py/cpu")


def validity18_start(names):
    """Start phase 18's processes `names` (side_start), each with one
    intra-op thread: with torch's default of one a core, six processes
    oversubscribed the cores of the check they run beside."""
    os.makedirs(SCRATCH, exist_ok=True)
    cmds = _cmds18()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for name in names:
        side_start(name, cmds[name], env=env)


def validity18_wait(names):
    """Wait for phase 18's processes `names`; prints how long the wait
    took beyond the check they ran beside. Their checks are phase 18's."""
    side_join("validity", names, "the check they ran beside")


def _validity18(card):
    """18(a): every compared key of each twin's artifact equal to the
    reference's committed artifact, its device the card; launches by
    script, score_update launched in each anchor run."""
    launches, walls = {}, {}
    for script, artifact, keys in VALIDITY18:
        proc, walls[script] = side_wait(script)
        check(proc.returncode == 0, f"18(a) {script} exited "
              f"{proc.returncode}: {proc.stdout[-1500:]} "
              f"{proc.stderr[-3000:]}")
        got = _strict_json(_out18(script + ".json"))
        with open(os.path.join(ROOT, "docs", artifact)) as f:
            want = json.load(f)
        keys = tuple(want) if keys is None else keys
        check(set(got) == {*keys, "device"}, f"18(a) {script}: keys "
              f"{sorted(got)} against {sorted(keys)} and device")
        for k in keys:
            check(got[k] == want[k], f"18(a) {script}: {k} {got[k]} != "
                  f"docs/{artifact}'s {want[k]}")
        check(got["device"] == card, f"18(a) {script}: device "
              f"{got['device']!r}, not {card!r}")
        launches[script] = json.loads(
            proc.stderr.strip().splitlines()[-1])["launches"]
        if script in ANCHORS18:
            check(launches[script]["score_update"] > 0,
                  f"18(a) {script}: score_update never launched")
        summary = (got["ours"] if "ours" in got else
                   [(r.get("loss_mode", r.get("muxer")), r["coverage"],
                     r["p50_ms"], r["p99_ms"])
                    for r in (got["runs"] if "runs" in got else
                              got["muxer_sensitivity"]["runs"])])
        print(f"[validity] 18(a) {script}: exit 0 in {walls[script]:.1f} s; "
              f"{', '.join(keys)} equal to docs/{artifact}; launches "
              f"{launches[script]}; {summary}")
    return launches, walls


def _service18():
    """18(b): the service-load twin on CUDA and on the CPU: exit 0 both
    times, bit_identical true, the simulation keys equal."""
    outs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        proc, walls[dev] = side_wait(f"service_load_torch.py/{dev}")
        check(proc.returncode == 0, f"18(b) service_load_torch.py --device "
              f"{dev} exited {proc.returncode}: {proc.stdout[-1500:]} "
              f"{proc.stderr[-3000:]}")
        outs[dev] = _strict_json(_out18(f"svc_{dev}.json"))
        check(outs[dev]["kill"]["bit_identical"] is True,
              f"18(b) --device {dev}: kill.bit_identical "
              f"{outs[dev]['kill']['bit_identical']}")
    differ = [k for k in SVC18_SIM_KEYS
              if outs["cuda"][k] != outs["cpu"][k]]
    check(not differ, f"18(b) service_load_torch.py: {differ} differ "
          f"between CUDA and the CPU")
    c = outs["cuda"]
    print(f"[validity] 18(b) service_load_torch.py at 48 peers, killed at "
          f"tick 6: exit 0 on CUDA ({walls['cuda']:.1f} s) and the CPU "
          f"({walls['cpu']:.1f} s), bit_identical on both, the simulation "
          f"keys equal; records sha {c['records_sha']}, {c['dispatched']} "
          f"dispatched, shed rate {c['shed_rate']:.4f}")
    return walls


def phase_18(card):
    """Phase 18's checks, on its processes (started and waited for by
    validity18_start / validity18_wait beside 3-3b(a) and 6(c)-3c)."""
    launches, walls = _validity18(card)
    walls.update({f"service_load_torch.py/{k}": v
                  for k, v in _service18().items()})
    print(f"[validity] phase 18: process walls "
          f"{ {k: round(v, 1) for k, v in walls.items()} }")
    return {k: {s: n[k] for s, n in launches.items()}
            for k in ("vmem_gather", "score_update")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        make_peer_mesh)

    started = time.time()
    dev = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        card = phase_build()
        kernels = phase_kernels(dev)
        validity18_start(VALIDITY18_A)
        with shared_cores():
            phase_parity(dev)
            phase_exact_parity(dev)
        validity18_wait(VALIDITY18_A)
        launches_exact, lossless = phase_config4(dev, "exact", EXACT_ARGS)
        phase_exact_idle(dev)
        launches_batch = phase_batch(dev)
        launches_resume = phase_resume(dev)
        validity18_start(VALIDITY18_B)
        with shared_cores():
            phase_resume_parity(dev)
            phase_lossy_parity(dev)
        validity18_wait(VALIDITY18_B)
        launches_lossy, lossy = phase_config4(
            dev, "lossy", LOSSY_ARGS, LOSSY_ENV, lossless, TcpDraws())
        phase_c2(dev, lossless, lossy)
        phase_membership_parity(dev)
        launches_c3 = phase_config3(dev)
        launches, main5 = phase_main(dev)
        launches_warm = phase_warm_twin(dev, main5)
        phase_idle(dev)
        dcn14_start()               # 14(c)'s process, beside 7(a)
        with shared_cores():
            phase_roles_parity(dev)
        side_join("roles", ("dcn14",), "7(a)")
        launches_roles = phase_roles(dev)
        service = phase_8(dev)
        launches_campaign, res9c, peak9c = phase_9(dev)
        launches10 = phase_10(dev)
        launches11 = phase_11(dev)
        launches12 = phase_12(dev)
        launches13 = phase_13(dev, kernels)
        launches14 = phase_14(dev, res9c, launches_campaign)
        # one 2-rank peer mesh serves phases 15 and 16
        with make_peer_mesh(devices=[dev] * MESH_RANKS) as mesh:
            launches15 = phase_15(dev, mesh, lossless, launches_exact)
            launches16 = phase_16(dev, mesh, res9c, peak9c)
            launches17 = phase_17(dev, mesh, main5)
        launches18 = phase_18(card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        side_stop()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    line = [dict(v, launches=launches[k],
                 exact=dict(v["exact"], launches=launches_exact[k]),
                 lossy=dict(v["exact"], launches=launches_lossy[k]),
                 config3=dict(launches=launches_c3[k]),
                 warm=dict(launches=launches_warm[k]),
                 batch=dict(launches=launches_batch[k]),
                 resume=dict(launches=launches_resume[k]),
                 roles=dict(launches=launches_roles[k]),
                 campaign=dict(launches=launches_campaign[k]),
                 faults=dict(launches=launches10["faults"][k]),
                 adaptive=dict(launches=launches10["adaptive"][k]),
                 dht=dict(launches=launches10["dht"][k]),
                 fused=dict(launches=launches11["fused"][k],
                            split_launches=launches11["split"][k]),
                 arena=dict(launches=launches11["arena"][k]),
                 conformance_campaign=dict(
                     launches=launches12["conformance_campaign"][k]),
                 plan=dict(launches=launches12["plan"][k]),
                 trace=dict(launches=launches12["trace"][k]),
                 microbench=dict(launches=launches13[k]),
                 trial_grid=dict(launches=launches14["ranks"][k],
                                 rank_launches=[
                                     r[k] for r in launches14["per_rank"]],
                                 caller_launches=launches14["caller"][k]),
                 peer_mesh=dict(
                     launches15["timed"][k],
                     launches=launches15["ranks"][k],
                     rank_launches=[r[k] for r in launches15["per_rank"]]),
                 campaign_mesh=dict(
                     launches=launches16["ranks"][k],
                     rank_launches=[r[k] for r in launches16["per_rank"]]),
                 mix_mesh=dict(
                     launches17["timed"][k],
                     launches=launches17["ranks"][k],
                     rank_launches=[r[k] for r in launches17["per_rank"]]),
                 validity=dict(launches=sum(launches18[k].values()),
                               script_launches=launches18[k]),
                 service=dict(
                     v["service"],
                     launches=service["batched"]["launches"][k],
                     sequential_launches=(
                         service["sequential"]["launches"][k])))
            for k, v in kernels.items()]
    print(card)      # again, near the end: the first lines scroll away
    print(json.dumps({"kernels": line}, allow_nan=False))
    print(f"[total] {time.time() - started:.1f} s of run time, builds "
          f"included")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    try:
        import dst_libp2p_test_node_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run it from "
              "the root of a checkout", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
