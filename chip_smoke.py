#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`areal_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and torch's name
2. build    nvcc builds every kernel of the serving and training paths from
            the sources in this checkout, one nvcc per source, all at once
            (-Xptxas -v report printed)
3. kernels  each kernel against its plain PyTorch version.  Ragged decode at
            the serving shapes (Qwen2.5-1.5B decode: B=16, T=1, Hq=12,
            Hkv=2, hd=128, bf16, page 128, K in {128, 2048}; T=4 at K=512;
            softcap 30 at K=128; one f32 case; T=4 writes straddling a
            key-chunk boundary; a write into [K, M); an all-masked row; the
            appended cache bit for bit; Gemma-2-2B's decode (B=8, Hq=8,
            Hkv=4, hd=256, softcap 50) at K=4096 and 8192 under sliding
            masks that drop keys, two runs bit-equal; Qwen3-1.7B's heads
            Hq=16, Hkv=8 at B=16; Gemma-2B's decode heads B=8, Hq=8, Hkv=1,
            hd=256 at K=2048), then one slot bit-equal alone and
            in the grid, and two runs bit-equal, at B=16 T=1 (the CUDA-core
            passes) and in a B=8 T=8 verify (the tensor cores).  Flash forward, dq and
            dk/dv at Qwen2.5's training heads (Hq=12, Hkv=2, hd=128, bf16):
            T=2048 packed with 3 segments and tail padding, T=1024 one
            segment, window 256, softcap 30, and f32 at T=256, and at
            Qwen3-1.7B's (Hq=16, Hkv=8) on the T=2048 rows; two forwards,
            two dq and two dk/dv runs equal bit for bit, pad rows' dq, dk
            and dv exactly 0, every bf16 kernel on its tensor-core variant
            and every f32 one on the CUDA cores; the same checks at head dim
            256 on Gemma-2B's heads (Hq=8, Hkv=1) and Gemma-7B's (Hq=16,
            Hkv=16): T=2048 with 3 segments and tail padding, T=1024 with
            window 256, with softcap 30 and (Gemma-7B) with both, f32 at
            T=256; every launch counted at its head dim.  The offset
            variant (a sequence shard's query rows against the whole row's
            K/V): the T=2048 rows cut into shards at q_start {0, 1024}
            (sp 2) and {0, 512, 1024, 1536} (sp 4), window 256 and softcap
            30 at sp 2, f32 at T=256, at Qwen2.5's and Gemma-2B's heads:
            each shard against its plain version (bf16 within the K1
            limits, f32 forwards within 1e-6), its out, lse and dq bit-equal
            to the unsharded kernels' rows, the shards' dk/dv partials
            summed against the unsharded kernel, the keys past a shard's
            last query exactly 0 in its partials, reruns bit-equal.  Every
            ragged call is checked on its variant: bf16 with at most 16
            rows a kv head at hd 64, 128 or 256 (decode, the short
            verifies) on the decode kernel `dec`, a bf16 verify of 17 to
            64 rows on the verify kernel `tc`, f32, mixed and longer
            verifies on the CUDA-core passes.
            `--only kernels` runs the build, these checks and 6b (a), then
            times the five T = 1 decode shapes, the verify at T = 4 and 8,
            K1 at hd 256 on rows shaped like the gemma1 phase's, the offset
            kernels at hd 256, and K1c at hd 256 at each cluster size
4. engine   a tiny f32 model served by the port's engine on the card and on
            the CPU: greedy streams equal, logprobs within 1e-4
5. serve    random seeded bf16 Qwen2.5-1.5B weights at full width (28
            layers), written as an HF checkpoint by the port's writer, served
            through `areal_tpu_torch.gen.server.main` over HTTP: 8 /generate
            and one /generate_batch of 4, 64 tokens each, 7 greedy; three of
            the batch's are a declared greedy group over one prompt, whose
            two siblings (its K/V fanned out from the representative, cache
            hits of all but one token) must return bit-equal streams; the
            kernel's launch count must equal 28 x the engine's decode steps,
            every launch on the decode kernel (`launches_dec`)
6. timings  ragged kernel, plain version and torch SDPA on the serving
            shapes (CUDA events; the kernel's and SDPA's device time per
            call, `device_ms`), the kernel's bound, decode tokens/s, and a
            torch.profiler window over steady decode steps (top device ops,
            the ragged kernel's share of device time)
6b. spec    speculative decoding, K2's verify half at T = D + 1: (a) K2
            against its plain version at T = 4 and 8 on Qwen2.5-1.5B's heads
            and Gemma-2B's decode heads, with short drafts and idle slots,
            the appended cache bit for bit, every one on the verify kernel
            `tc`; at T = 4 and 8 on Qwen3-1.7B's and Gemma-2-2B's heads (8
            and 16 rows) on the decode kernel `dec`; at T = 16 on Qwen2.5's
            heads (96 rows a kv head) on the CUDA-core passes;
            (b) in process, f32 at 4 layers
            of full width, spec off, D = 3 and the ladder (0, 3, 7) on one
            greedy-and-sampled workload: equal token streams, logprobs
            within 1e-3, every accepted draft the sampled token, K2
            launches = 4 x (decode steps + verify calls), those at T > 1
            counted apart = 4 x verify calls, none on `dec` or `tc` (f32);
            (c) `python -m
            areal_tpu_torch.gen.server` on a checkpoint of the serve
            phase's model cut to SPEC_PPO_LAYERS (8) layers with
            --spec-decode and without (8 slots each, the launch helper),
            the same 8 requests (64..512-token prompts of tiled spans, 128
            new tokens, half greedy): tokens/s, drafted, accepted, verify
            calls, K2 launches = layers x (decode steps + verify calls)
            and the server's count of those at T > 1 = layers x verify
            calls, the
            Prometheus series, and the logprob gap on against off before
            each request's first divergent position; (d) K2 at T = 4 and 8
            (on the tensor cores) timed (events, device time) with its bound,
            plain version and SDPA on the same boolean mask.  `--only spec`
            runs the build, a checkpoint and this phase alone
6c. tiers   the serve phase's model (28 layers) in process, two engines of
            16 slots x 2048: tiered (decode_tiers=2: ceilings 1024 and 2048,
            8 slots each; the host tier on, 2048 MiB) and untiered.  16 greedy
            requests (8 of 900..950 tokens and 128 new, 4 "movers" of
            760..800 and 256 new that find the long tier full and start in
            the short one, 4 of 700..900 and 64 new) through both (after a
            warm-up batch of the same shapes, untiered first, both timed): streams
            equal token for token, migrations > 0, K2 = 28 x (decode steps +
            verify calls) on the tiered run.  16 fillers spill every
            retained prefix to the host tier; a mover's transcript comes back
            and swaps in: its row's bytes equal the spilled bytes and its
            greedy continuation equals the untiered engine's, whose prefix
            never left the device; spill and swap-in of a 1024-token block
            (29.4 MB) timed through the pinned staging buffer.  Staged
            weights: `stage_params` from host tensors on a thread while 16
            requests decode, `commit_staged(live=True)` and `(live=False)`
            each advancing the version, their pauses against `load_weights`
            of the same host tensors.  `--only tiers` runs the build, a
            28-layer checkpoint and this phase
7. train    the PPO actor on the serve phase's checkpoint at full width (f32
            masters, bf16 compute, full remat) beside a server of the same
            checkpoint: 8 prompts x group 4 rolled out over HTTP (256 new
            tokens each), the trainer's logprobs against the server's,
            advantages, 3 PPO updates (loss, grad norm, tokens/s, MFU), the
            policy moving along the advantages, exact flash launch counts
            (every bf16 forward, dq and dk/dv on its tensor-core kernel:
            168 dq and 168 dk/dv launches), a torch.profiler window over the
            third update (top device ops, groups of them, the flash kernels'
            share, the device's busy share; its step times are printed but
            left out of the steady step time, which the profiler would
            slow), and the new weights published to the server and read back
8. flash timings  on the train phase's packed rows (bf16, T=1024, Hq=12,
            Hkv=2, hd=128): each flash kernel against its plain version,
            then the kernel, its plain version and torch SDPA (the forward,
            and forward + backward) timed, with each bound, and the kernels'
            and SDPA's device time per call (`device_ms`: a CUDA graph of
            the calls replayed, timed by events)
8b. sp      the sequence-parallel training path at full width and
            SP_LAYERS (8) layers: the PPO actor of
            `areal_tpu_torch/scripts/mp_train_worker.py` on its seeded batch
            (8 prompts x group 4, 128..512-token prompts, 256 new tokens,
            1024-token rows, two minibatches an update; random
            weights from seed 0, f32 masters, bf16 compute, full remat) at
            sp = 1 in this process, then as two ranks sharing the card at
            sp = 2 (gloo: NCCL refuses two ranks on one device): the head
            alone rolls out and broadcasts, logprobs, advantages and
            SP_STEPS ppo_updates.  Prints the backend, each rank's peak
            memory, seconds in collectives and K1 launches (exactly layers
            x forwards on every rank, on the tensor cores), and the
            logprob, loss and grad-norm differences from sp = 1; the ranks'
            parameters must be bit-equal after every update.  Then f32 at
            SP_F32_LAYERS layers: logprobs within 1e-5, losses within 1e-5
            relative.  Then the offset kernels timed per shard on the
            phase's rows and on 8 rows of 2048 (events, device time, plain
            version, SDPA on the same [Tq, Tk] boolean mask, bound).
            `--only sp` runs the build, the offset checks and this phase
9. grpo     the asynchronous GRPO loop of `areal_tpu_torch.scripts.bench_e2e_grpo`
            at full width from a checkpoint of the serve phase's model cut
            to REMOTE_LAYERS (4) layers, which the remote and router
            phases then reuse, trainer (f32
            masters, bf16 compute, full remat, decoupled loss, logprob
            recompute) and `ColocatedEngine` (32 slots, max_seq_len 1024,
            bf16, prefix reuse and group fan-out on) in this process: 8
            random prompts of 64..256 tokens x group 4 per step, generation
            budgets log-uniform in 64..256 (the bench's --len-jitter 3), the
            parity reward, group advantage normalisation.  Sync: 1 warmup +
            1 timed step of rollout_batch, train_phase (serving memory
            released), publish_weights.  Async: 1 + 1 steps through
            WorkflowExecutor.prepare_batch (max_head_offpolicyness 4, 16
            concurrent rollouts, consumer batch 8) with a live publish after
            each; then one async step with an interrupting publish, in a
            torch.profiler window (CUDA only: top device ops, groups of
            them, launches, the device's busy share).  Prints
            trajectories/s/chip and effective tokens/s/chip per mode and
            their ratio, every pause window, each step's rollout wait and
            train time, the version-lag histogram, the launches, the prefill
            accounting (cold, shared, suffix and reused tokens, fan-out
            copies; shared > 0 required) and the requests' TTFT, e2e and
            inter-token p50/p99 per mode.
            Checks: ragged launches = layers x decode steps, every flash
            launch on its tensor-core kernel and exactly 3/1/1 x layers per
            step, the
            staleness ledger balanced, no consumed token from a version
            above the trainer's, trainer logprobs against the server's on
            same-version tokens, no reward timeout, and the served weights
            bit-equal to the trainer's bf16 cast after the last publish
10. prefix  KV prefix reuse and group fan-out on Qwen2.5-1.5B at full width
            (random weights, seed 0) in the grpo cell's engine (32 slots,
            max_seq_len 1024): 8 prompts of 64..256 tokens x group 4, groups
            declared, streams pinned, admitted in one pass with sharing on
            and off (bf16, sampled): the token accounting of each (cold +
            shared + suffix + reused = the prompt tokens), the admission's
            wall and device time (warm, on fresh engines), first-token
            logprobs on against off within FIRST_LOGP_*; then f32 at 4
            layers, greedy: streams equal with sharing on and off, and an
            abort_all after the first decode chunk whose resubmits (prompt +
            accumulated tokens) reuse their retained prefixes and resume
            every stream exactly.  Ragged launches = layers x decode steps
            in every run
11. families  the dense families at full width, random weights from seed 0,
            each written as an HF checkpoint by the port's writer from its
            published config.json.  Gemma-2-2B (GEMMA2_LAYERS, 10, of its
            26 layers, d=2304, 8 q / 4 kv heads of 256, vocab 256000,
            softcaps 50/30, window 4096 on even layers) through
            `gen.server.main` (8 slots, max_seq_len 8192): a greedy request
            with a 4,500-token prompt, then three shorter (64 new tokens
            each); K2 launches = layers x decode steps
            (/metrics); the long request's served logprobs against the
            packed forward with the per-layer windows (within LOGP_MEAN_TOL
            on the mean), which without the windows must move by more than
            that; 8 prompts x group 4 over HTTP, the actor's logprob
            recompute against the server's, 2 PPO updates (f32 masters, bf16
            compute, full remat, naive attention under the per-layer
            windows as in JAX: no flash launch, the softcapped chunked
            head; loss, grad norm, tokens/s, MFU), a disk publish the
            server reloads (snapshot bit-equal to the trainer's bf16 cast),
            decode tokens/s.  Qwen3-1.7B (d=2048, 16 q / 8 kv heads, qk
            norm; its 28 layers cut to QWEN3_LOOP_LAYERS, 4) through the
            grpo phase's colocated loop from its checkpoint: sync and async
            (live publish), 1 + 1 steps each, with the grpo phase's checks.  Then K2 at both models' decode
            shapes and K1 at Qwen3's heads on its train rows timed against
            their plain versions and SDPA, with bounds
12. gemma1  Gemma-2B (google/gemma-2b's config.json, its 18 layers cut to
            GEMMA1_LAYERS, 6: d=2048, 8 q heads on 1 kv head of 256, vocab
            256000, exact gelu, tied head), random bf16 weights from seed 0
            written by the port's writer, served through `gen.server.main`
            (8 slots, max_seq_len 2048): 8 prompts of 128..512 tokens x
            group 4, 128 new tokens each over HTTP, K2 = layers x decode
            steps (/metrics); the PPO
            actor (f32 masters, bf16 compute, full remat) on the rollouts
            in 1024-token rows: the logprob recompute against the server's
            within LOGP_MEAN_TOL, 2 ppo_updates (loss, grad norm, tokens/s,
            MFU), every K1 launch at hd 256 on the tensor cores, exactly one
            K1a a layer in the recompute and two K1a, one K1b and one K1c a
            layer per update micro-batch; a disk publish the server reloads (snapshot
            bit-equal to the trainer's bf16 cast).  Then, the server
            stopped, the rung ladder: from the actor's state (masters and
            Adam's moments parked in pinned host memory), one update on one
            batch of 8 packed 1024-token rows under full, save_attn,
            save_mlp, dots and carry_offload (one layer a checkpoint) and
            full with 2 and 3 layers a checkpoint: loss, grad norm and the
            updated masters bit-equal to full with one layer; each one's
            peak memory, train_batch time and K1a count (2 a layer under
            full, save_mlp and dots, 1 under save_attn and carry_offload).
            Then K1a/b/c at hd 256 on the phase's train rows (K1c's cluster
            size printed), K2 at its decode shape, and the offset kernels at
            hd 256 per shard of phase 3's T=2048 rows at sp 2 and 4 timed
            against their plain versions and SDPA, with bounds.  `--only
            gemma1` runs the build and this phase alone
13. remote  the same cell with trainer and server as two processes on the
            card: `areal_tpu_torch.gen.server` started by the launch helper
            (32 slots, max_seq_len 1024, bf16, from the grpo phase's
            checkpoint of REMOTE_LAYERS (4) layers), the
            trainer here, rollouts over HTTP through
            `RemoteTorchEngine` (`bench_e2e_grpo.run_mode_remote`).  Sync
            with the disk publish (1 + 1 steps), async with the transfer
            publish and a live commit (1 + 1 steps, max_head_offpolicyness
            4), one async step with an aborting commit.  Prints
            trajectories/s/chip and effective tokens/s/chip per mode, stage
            and commit times, the server's pause windows, version lags,
            both processes' peak memory and the server's prefill accounting
            from /metrics (shared > 0 required).  Checks: the server's ragged
            launches (over HTTP, /metrics) = layers x its decode steps, the
            trainer's flash launches 3/1/1 x layers per step on the tensor
            cores,
            the ledger balanced, no token from a future version, the logprob
            gap, no reward timeout, no lost trajectory, the server at the
            trainer's version, and after the last publish 4 greedy streams
            (and logprobs) from the server process bit-equal to a GenEngine
            built here from the trainer's bf16 export
13b. router two servers behind the port's router on the grpo phase's
            checkpoint of REMOTE_LAYERS (4) layers, every process found
            through name_resolve (NFS under
            build/): the launcher starts the servers from the allocation
            mode jax:d2+d1 (each registers), the router is `python -m
            areal_tpu_torch.gen.router` (least_requests, the fleet gate at
            --train-batch-size 32 --max-head-offpolicyness 1, the checkpoint
            watcher on the trainer's publish directory, probes every 1 s,
            threshold 3, probe timeout 2 s), the trainer here with two
            `RemoteTorchEngine` clients that find the router's gate and send
            their requests through it (failover_retries 5; 128 new tokens a
            trajectory).  A sync step with a disk publish (the watcher, not
            the trainer, flushes both servers), two async steps with
            transfer publishes (the trainer finds the servers in
            name_resolve and posts /set_version to the router), a sync step
            with a disk publish, then a rollout in which server 1 is
            SIGKILLed: it finishes on server 0, server 1 restarts at the same
            address from the checkpoint (version 0), and the router
            force-reloads it before it closes.  Checks: both servers
            served, every group on one server (the servers' arrival logs),
            shared prefill > 0 on each, K2 = layers x decode steps on each
            server process, flash 3/1/1 x layers a step on the tensor
            cores, fleet and
            router at the trainer's version after every publish, the breaker
            open within threshold x interval + probe timeout + 2 s and
            failovers >= 1, no trajectory lost, the gate's ledger balanced
            (accepted = the clients', none running) and never over (1 +
            version + 1) x 32 in the polled /metrics, the Prometheus
            exposition's areal_router_* names, and 4 greedy streams from
            each server (the rejoined one too) bit-equal to each other and to
            a GenEngine on the trainer's bf16 export.  Prints
            trajectories/s/chip per mode, requests per server, the gate's
            409s, each flush's pause-to-resume time, kill to open and
            restart to closed, and each process's peak memory.  `--only
            router` runs the build and this phase alone
13c. ppo    PPO with a learned critic, `python -m
            areal_tpu_torch.examples.math.gsm8k_ppo`'s loop (`gsm8k_grpo.run`
            with a `PPOConfig`, the example yaml's values) on the spec
            phase's checkpoint of SPEC_PPO_LAYERS (8) layers: actor and
            critic (f32 masters, bf16 compute, full remat, 2 minibatches of
            2 micro-batches each) here, one server process on the card (32
            slots, max_seq_len 1024, the launch helper); 8 prompts x group
            4, PPO_NEW (128) new tokens, PPO_STEPS (3) asynchronous steps
            (the first finds nothing in flight, as a sync step), transfer
            publishes (nothing written to disk), the parity reward.
            Checks: the trainer-against-server logprob gap on same-version
            tokens over the phase, the critic's values finite and nonzero
            after step 1, the flash launches of every step exactly layers
            x (2 forwards + 2 x 8 train micro-batches) K1a and layers x 8
            K1b and K1c, all on the tensor cores, the server's K2 = layers x
            decode steps (/metrics); then the critic's values through K1
            against naive attention (mean |diff| within VALUE_REL_TOL of the
            mean |value|), and the forced critic save of the last step (a
            tied bf16 backbone and `value_head.npy`) reloaded into a fresh
            critic: values bit-equal to the live critic's on its masters
            rounded to bf16.  `--only ppo` runs the build, an 8-layer
            checkpoint and this phase
13d. algo   SFT, the reward model, AEnt and the critic at Qwen2.5-1.5B's
            full width and 28 layers, in process, one engine at a time
            from one seeded init (f32 masters, bf16 compute, full remat,
            the example yamls' optimizers), no disk writes.  SFT: the loss
            through K1 against naive attention within LOGP_MEAN_TOL, then
            3 `train_lm` steps on 16 packed rows of 1024 of gsm8k-synth
            solutions (tokens/s, MFU, loss and ppl finite).  RW: 3
            `train_rw` steps on RW_PAIRS (15) gsm8k-synth preference pairs,
            one sequence a row of 1024 (two rows filler end to end); K1 on
            one micro-batch of those rows against its plain version and
            timed with its bound and SDPA, each filler row's out 0, lse
            -inf and gradients exactly 0 on the kernels and the plain
            versions.  AEnt: one update with the entropy clamp 0.2 at vocab
            151936, the kthvalue threshold against an f32 full sort on a
            chunk of the update's logits (within 1e-3) and the clamp's time.
            Critic: one `ppo_update` with a seeded nonzero value head, the
            last layer's dq and dk/dv inputs replayed through K1b and K1c
            and their plain versions (a nonzero dout).  `--only algo` runs
            the build and this phase
13e. disagg  run right after the router phase, on its checkpoint of
            REMOTE_LAYERS (4) layers: `python -m areal_tpu_torch.gen.server
            --role prefill` and `--role decode` (8 slots x 2048 each; decode
            runs the host tier) behind `python -m areal_tpu_torch.gen.router
            --disagg`.  8 requests of 256..900-token prompts and 64 new
            tokens, half greedy and half sampled, streams pinned, one after
            another through the router.  Checks: handoffs 8 and fallbacks 0
            (the router's /metrics), the decode server's 8 imports swapped
            in and its K2 = layers x its decode steps, and each merged
            stream (tokens and logprobs) equal to the same two-leg split
            served by the prefill server alone (its retained prefixes first
            overwritten by a batch of fillers, so that leg 1 prefills cold
            there too).  Prints the bytes a handoff, export + import ms
            through the router and its MB/s, and the workers' export and
            import service times.  `--only disagg` runs the build, a 4-layer
            checkpoint and this phase
14. recover the training job at full width.  In process: Qwen2.5-1.5B's
            width at 4 layers, the example's actor config, one update,
            `save` with the optimizer, `load` into a fresh actor (masters,
            mu/nu and the update count bit-equal), then one `ppo_update` on
            one batch from both: bit-equal, every flash launch counted on
            the tensor cores; the ref engine (bf16, 28 layers) forward on
            the grpo phase's sequences: one K1a per layer, within
            LOGP_MEAN_TOL of naive attention.  Then `python -m
            areal_tpu_torch.examples.math.gsm8k_grpo --launch` for 3 steps
            at full width and RECOVER_RUN_LAYERS (2) layers, from a random
            bf16 HF checkpoint (seed 0) that trainer, ref engine and server
            load: 256 new tokens, the transfer publish, kl_ctl 0.001 with
            the ref engine, 32 held-out gsm8k-synth problems evaluated at
            every step, a recover generation at steps 1 and 2 keeping 1, a
            bf16 export at step 2, recover.mode fault with 1 retry, and
            AREAL_FAULT_POINTS=train_step@2:kill: run 0 dies after step 1,
            the launcher relaunches it, run 1 resumes.  Checks: exit 0,
            the StatsLogger's global_step [0, 1, 2], run_id [0, 0, 1],
            version [1, 2, 3]; run 1's first requests to the server (its
            arrival log) the transfer reload pinned to version 2,
            committed with an abort, before any generate; the ledger on
            every step; lost = settled; the step-1 generation loaded (its
            digests checked by the load); finite loss, nonzero KL and an
            eval reward every step; the trainers' flash launches (10/4/4 x
            layers per step, tensor cores) and the server's ragged
            launches (layers x decode steps, from its last /metrics).
            Prints the free disk, each dump's seconds and GB (write,
            digests, fsync), the load (validate, restore, replay), kill to
            run 1's first trained step, the ref forward and eval per step,
            trajectories/s/chip per run.  The depth is cut because the
            card's host takes 45 GiB of disk writes per run (RECOVER_RUN_LAYERS).
            `--only recover` runs the build and this phase alone;
            `--only recover-full-depth` the build and the launched run
            alone at 28 layers (18.5 GB per recover generation)

Depth cuts, to keep the whole script under 900 s and under the card
host's 45 GiB of disk writes a call (all at full width): the spec
servers and the ppo loop at SPEC_PPO_LAYERS (8; the spec servers ran the
serve phase's 28 layers before the ppo phase came), the sp phase's bf16 run at
SP_LAYERS (8; at 28 its two ranks took 60.6 s on an H100, 16 of each
update's 18 s summing f32 gradients through gloo, and at 4 they took no
less than at 8) and its f32 run at SP_F32_LAYERS (2; 4 before).  To make
room for the ppo and algo phases (about 80 s together) the colocated,
remote and router loops went to REMOTE_LAYERS (4; 8 before, and the
colocated loop 28 before that), Gemma-2-2B to GEMMA2_LAYERS (10 of 26),
Gemma-2B to GEMMA1_LAYERS (6 of 18), the Qwen3-1.7B loop to
QWEN3_LOOP_LAYERS (4; 8 before) and the recover phase's launched run to
RECOVER_RUN_LAYERS (2; 4 before).

After the card's line comes the whole run's wall time.  The line before
the last is the kernels' JSON record (`launches` sums the
paths that ran each kernel, `launches_by_path` splits them); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.
"""

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from areal_tpu_torch.api.config import NormConfig, OptimizerConfig, PPOActorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.gen import server as gen_server
from areal_tpu_torch.gen.engine import GenEngine, GenRequest
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.hf import save_hf_checkpoint
from areal_tpu_torch.models.model_config import TransformerConfig, qwen25_1p5b, tiny_config
from areal_tpu_torch.models.transformer import build_model, init_params
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops.ragged_decode import (
    _copied_end,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    variant,
)
from areal_tpu_torch.scripts import mp_train_worker as mp_worker
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
BF16_ATOL = BF16_RTOL = 2e-2  # see check_kernel
SERVE_LAYERS = 28
# the decode heads of the families phase's models (B = its slot grid)
GEMMA2_HEADS = dict(Hq=8, Hkv=4, hd=256)  # Gemma-2-2B: 8 q heads on 4 kv heads
GEMMA_DECODE = dict(B=8, **GEMMA2_HEADS)
QWEN3_HEADS = dict(Hq=16, Hkv=8, hd=128)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name} done in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------


def ragged_case(seed, *, B=16, T=1, Hq=12, Hkv=2, hd=128, K=2048, M=2048,
                page=128, dtype=torch.bfloat16, lengths=None, window=None, dev="cuda"):
    """Inputs of one ragged call: permuted page-table rows, lengths with 0
    and K - T, one dropped write position (index M); with `window`, a
    sliding layer's mask (keys inside the window only, which must drop
    some)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    S = B + 1

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    if lengths is None:
        lengths = torch.randint(0, K - T + 1, (B,), generator=g)
        lengths[0], lengths[1] = 0, K - T
    pos = lengths.to(torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)[None, :]
    mask = torch.arange(K)[None, None, :] <= pos[:, :, None]
    if window:
        causal = mask
        mask = mask & (torch.arange(K)[None, None, :] > pos[:, :, None] - window)
        if torch.equal(mask, causal):
            raise AssertionError(f"the window {window} drops no key at K={K}")
    widx = pos.clone()
    widx[2, -1] = M  # a dropped write (idle slot / short draft padding)
    return dict(
        q=randn(B, T, Hq, hd), k_new=randn(B, T, Hkv, hd), v_new=randn(B, T, Hkv, hd),
        ck=randn(S, M, Hkv, hd), cv=randn(S, M, Hkv, hd),
        rows=torch.randperm(S, generator=g)[:B].to(torch.int32).to(dev),
        lengths=lengths.to(torch.int32).to(dev), widx=widx.to(dev), mask=mask.to(dev),
        key_window=K, page_size=page,
    )


def straddle_chunk(case):
    """Slot 0 at length 62: a T=4 verify writes 62..65, across the kernel's
    key-chunk boundary at 64."""
    T = case["q"].shape[1]
    K = case["key_window"]
    case["lengths"][0] = 62
    case["widx"][0] = 62 + torch.arange(T, dtype=torch.int32)
    keys = torch.arange(K, device=case["mask"].device)
    case["mask"][0] = keys[None, :] <= case["widx"][0][:, None]


def tail_write(case):
    """Slot 3's last write lands in [K, M): stored, never read."""
    case["widx"][3, -1] = (case["key_window"] + case["ck"].shape[1]) // 2


def all_masked(case):
    """Slot 4 attends nothing: naive_attention's uniform average over K."""
    case["mask"][4] = False


def _run(fn, case, softcap=None):
    args = dict(case, ck=case["ck"].clone(), cv=case["cv"].clone())
    return fn(**args, logit_softcap=softcap)


def check_kernel():
    """Kernel against plain version.  bf16 tolerance: both round the f32
    scores and the probabilities to bf16, after f32 sums taken in another
    order (warp shuffles against cuBLAS), so an element can land one bf16
    step apart; a few such steps stay well inside 2e-2 at these magnitudes.
    f32: 1e-5.  The appended cache must be equal bit for bit."""
    cases = [
        ("T=1 K=128", dict(K=128), None),
        ("T=1 K=2048", dict(K=2048), None),
        ("T=4 K=512", dict(T=4, K=512), None),
        ("softcap 30 K=128", dict(K=128), 30.0),
        ("f32 T=1 K=256", dict(K=256, dtype=torch.float32), None),
        ("T=4 K=512, writes across a chunk boundary", dict(T=4, K=512), None, straddle_chunk),
        ("T=4 K=512 M=1024, a write into [K, M)", dict(T=4, K=512, M=1024), None, tail_write),
        ("T=1 K=1024, an all-masked row", dict(K=1024), None, all_masked),
        ("Gemma-2-2B decode (B=8 Hq=8 Hkv=4 hd=256) K=4096, softcap 50, window 2048",
         dict(GEMMA_DECODE, K=4096, M=4096, window=2048), 50.0),
        ("Gemma-2-2B decode K=8192, softcap 50, its window 4096",
         dict(GEMMA_DECODE, K=8192, M=8192, window=4096), 50.0),
        ("Qwen3-1.7B decode heads (B=16 Hq=16 Hkv=8 hd=128) K=2048", dict(QWEN3_HEADS), None),
        ("Gemma-2B decode (B=8 Hq=8 Hkv=1 hd=256) K=2048", dict(GEMMA1_DECODE), None),
    ]
    worst = 0.0
    for i, (name, kw, softcap, *edit) in enumerate(cases):
        case = ragged_case(100 + i, **kw)
        for fn in edit:
            fn(case)
        max_err = compare_ragged(name, case, softcap)
        if case["q"].dtype != torch.float32:
            worst = max(worst, max_err)
        if kw.get("hd") == 256:
            first, second = _run(ragged_paged_attention, case, softcap), _run(
                ragged_paged_attention, case, softcap)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"two ragged runs differ: {name}")
            print("    two runs bit-equal")
    check_ragged_invariance()
    return worst


def k2_variant(case):
    """The variant `ragged_decode_launch` picks for a case."""
    _, T, Hq, hd = case["q"].shape
    return variant(case["q"].dtype, case["ck"].dtype, T, Hq // case["ck"].shape[2], hd)


def k2_variant_counts():
    """(calls on dec::ragged_dec, on tc::ragged_tc, all calls) so far."""
    w = ragged_paged_attention
    return np.array([w.launches_dec, w.launches_tc, w.launches])


def ran_variant(before, n=1):
    """The variant of the last `n` K2 calls since `before`
    (`k2_variant_counts`), all one; "mixed" when they were not."""
    dec, tc, total = k2_variant_counts() - before
    if total != n:
        return "mixed"
    return "dec" if dec == n else "tc" if tc == n else "passes" if dec == tc == 0 else "mixed"


def compare_ragged(name, case, softcap=None):
    """The ragged kernel against its plain version on one case (tolerances
    as in `check_kernel`), on the variant the rule picks.  Returns
    max|out - plain|."""
    before = k2_variant_counts()
    got = _run(ragged_paged_attention, case, softcap)
    ran = ran_variant(before)
    want = _run(ragged_paged_attention_plain, case, softcap)
    torch.cuda.synchronize()
    f32 = case["q"].dtype == torch.float32
    if ran != k2_variant(case):
        raise AssertionError(f"{name}: K2 ran on {ran}, the rule says {k2_variant(case)} "
                             "(bf16 with at most 16 rows a kv head: dec; a bf16 verify of "
                             "17 to 64: tc; the rest: the CUDA-core passes)")
    atol, rtol = (1e-5, 1e-5) if f32 else (BF16_ATOL, BF16_RTOL)
    err = (got[0].float() - want[0].float()).abs()
    bad = err > atol + rtol * want[0].float().abs()
    max_err = float(err.max())
    cache_ok = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    print(f"  {name} [{ran}]: max|out - plain| = {max_err:.3e} "
          f"(atol {atol}, rtol {rtol}), {int(bad.sum())} outside, "
          f"cache equal: {cache_ok}")
    if bad.any() or not cache_ok or not torch.isfinite(got[0]).all():
        raise AssertionError(f"ragged kernel disagrees with its plain version: {name}")
    return max_err


def check_ragged_invariance():
    """Fixed key chunks and no atomics, on each of K2's variants: two runs
    of the grid are bit-equal (out and caches), and a slot run alone (B=1)
    gives the same out, bit for bit, as inside the grid.  dec: decode
    (B=16, T=1, Qwen2.5's heads) and Qwen3-1.7B's T = 8 verify (16 rows);
    tc: a bf16 verify at T = 8 (B=8, Qwen2.5's heads); the passes: f32
    decode.  The verifies with short drafts and idle slots."""
    for label, case, slots in (
            ("B=16 T=1", ragged_case(120, K=1024), (0, 5, 15)),
            ("B=8 T=8 verify, Qwen3-1.7B's heads", verify_case(122, 8, B=SPEC_SLOTS, K=1024,
                                                               M=1024, **QWEN3_HEADS),
             (0, 2, 6)),
            ("B=8 T=8 verify", verify_case(121, 8, B=SPEC_SLOTS, K=1024, M=1024), (0, 2, 6)),
            ("f32 B=16 T=1", ragged_case(123, K=1024, dtype=torch.float32), (0, 5))):
        before = k2_variant_counts()
        first, second = _run(ragged_paged_attention, case), _run(ragged_paged_attention, case)
        torch.cuda.synchronize()
        ran = ran_variant(before, 2)
        if ran != k2_variant(case):
            raise AssertionError(f"{label}: K2 ran on {ran}, the rule says {k2_variant(case)}")
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"two ragged runs on the same inputs differ ({label})")
        for slot in slots:
            alone = {k: (v[slot:slot + 1] if k in ("q", "k_new", "v_new", "rows", "lengths",
                                                   "widx", "mask") else v)
                     for k, v in case.items()}
            out = _run(ragged_paged_attention, alone)[0]
            if not torch.equal(out[0], first[0][slot]):
                raise AssertionError(f"{label}: slot {slot} alone differs from slot {slot} "
                                     "in the grid")
        print(f"  {label} [{ran}]: two runs bit-equal; "
              f"slots {', '.join(map(str, slots))} alone (B=1) bit-equal to the grid")


def packed_segments(T, seg_lens):
    """int32 [1, T] segment ids: contiguous segments of `seg_lens`, the
    rest tail padding (-1)."""
    seg = torch.full((1, T), -1, dtype=torch.int32)
    start = 0
    for s, n in enumerate(seg_lens):
        seg[0, start:start + n] = s
        start += n
    return seg


def flash_case(seed, seg, *, Hq=12, Hkv=2, hd=128, dtype=torch.bfloat16, dev="cuda"):
    """Pre-scaled q_s, k, v and an output cotangent for packed rows `seg`."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, T = seg.shape

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    qs = fa.scale_query(randn(B, T, Hq, hd))
    return qs, randn(B, T, Hkv, hd), randn(B, T, Hkv, hd), randn(B, T, Hq, hd), seg.to(dev)


def compare_flash(name, qs, k, v, dout, sg, window=None, softcap=None):
    """Flash forward, dq and dk/dv against their plain versions on the
    valid rows of one input.  bf16: both round the f32 results once to bf16
    after f32 sums in another order (an online softmax over 64-key tiles
    against one pass), so an element can land a bf16 step or two apart:
    2e-2, like the ragged check (out: absolute plus relative; gradients:
    relative to the largest element).  f32: 1e-5 on out, 1e-4 relative to
    the largest element on gradients.  Two runs of each kernel must be equal
    bit for bit (no atomics), pad rows must get dq = dk = dv = 0 exactly,
    each kernel must run on its tensor-core variant for bf16 and on the
    CUDA cores for f32, and every launch must be counted at the input's
    head dim.  Returns |kernel - plain| of out, dq and dk/dv."""
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    hd = qs.shape[-1]
    tc0 = [w.launches_tc for w in wrappers]
    hd0 = [w.launches_hd[hd] for w in wrappers]
    out, lse = fa.flash_fwd(qs, k, v, sg, window, softcap)
    out2, lse2 = fa.flash_fwd(qs, k, v, sg, window, softcap)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di, window, softcap)
    dq2 = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di, window, softcap)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, window, softcap)
    dk2, dv2 = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di, window, softcap)
    tc_runs = [w.launches_tc - n for w, n in zip(wrappers, tc0)]
    hd_runs = [w.launches_hd[hd] - n for w, n in zip(wrappers, hd0)]
    p_out, p_lse = fa.flash_fwd_plain(qs, k, v, sg, window, softcap)
    p_dq = fa.flash_bwd_dq_plain(qs, k, v, sg, dout, p_lse, di, window, softcap)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, p_lse, di, window, softcap)
    torch.cuda.synchronize()
    f32 = qs.dtype == torch.float32
    valid = sg >= 0  # [B, T]
    err = (out.float() - p_out.float()).abs()[valid]
    atol, rtol = (1e-5, 1e-5) if f32 else (BF16_ATOL, BF16_RTOL)
    bad = int((err > atol + rtol * p_out.float().abs()[valid]).sum())
    grad_tol = 1e-4 if f32 else BF16_RTOL
    rels, abss = [], []
    for a, b in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        diff = (a.float() - b.float()).abs()
        rels.append(float(diff.max() / b.float().abs().max()))
        abss.append(float(diff.max()))
    rerun_equal = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    fwd_equal = torch.equal(out, out2) and torch.equal(lse, lse2)
    pad = sg < 0
    pad_zero = not (dq[pad].any() or dk[pad].any() or dv[pad].any())
    print(f"  {name}: max|out - plain| = {float(err.max()):.3e} ({bad} outside atol "
          f"{atol} rtol {rtol}); dq, dk, dv max|diff|/max = "
          f"{rels[0]:.2e}, {rels[1]:.2e}, {rels[2]:.2e} (tol {grad_tol}); "
          f"forward and dq, dk/dv reruns equal: {fwd_equal}, {rerun_equal}; "
          f"pad rows' grads 0: {pad_zero}; fwd/dq/dkv runs on the tensor cores: "
          f"{tc_runs} of 2 each")
    finite = all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
    if (bad or max(rels) > grad_tol or not rerun_equal or not fwd_equal or not finite
            or not pad_zero):
        raise AssertionError(f"flash kernels disagree with their plain versions: {name}")
    if tc_runs != [0 if f32 else 2] * 3 or hd_runs != [2] * 3:
        raise AssertionError(f"{name}: a kernel ran on the wrong variant")
    return {"flash_fwd": float(err.max()), "flash_bwd_dq": abss[0],
            "flash_bwd_dkv": max(abss[1], abss[2])}


def check_flash():
    """`compare_flash` on single packed rows at Qwen2.5's heads: several
    segments with tail padding, one segment, a window, a softcap, and f32;
    at Qwen3-1.7B's; and at head dim 256: Gemma-2B's (8 q heads on one kv
    head) and Gemma-7B's (16 on 16) heads, on the same kinds of rows, and
    Gemma-2-2B's (8 on 4) with its window and softcap on a row past the
    window.
    Returns the worst bf16 |kernel - plain| per kernel at hd 128 and at hd
    256."""
    g2b, g7b = GEMMA1_HEADS, GEMMA7B_HEADS
    cases = [
        ("T=2048, 3 segments + padding", packed_segments(2048, [700, 900, 300]), {}),
        ("T=1024, one segment", packed_segments(1024, [1024]), {}),
        ("T=1024, window 256", packed_segments(1024, [600, 380]), dict(window=256)),
        ("T=1024, softcap 30", packed_segments(1024, [600, 380]), dict(softcap=30.0)),
        ("f32 T=256", packed_segments(256, [100, 140]), dict(dtype=torch.float32)),
        ("Qwen3-1.7B heads (Hq=16 Hkv=8), T=2048, 3 segments + padding",
         packed_segments(2048, [700, 900, 300]), dict(Hq=16, Hkv=8)),
        ("hd 256, Gemma-2B heads (Hq=8 Hkv=1), T=2048, 3 segments + padding",
         packed_segments(2048, [700, 900, 300]), dict(g2b)),
        ("hd 256, Gemma-7B heads (Hq=16 Hkv=16), T=2048, 3 segments + padding",
         packed_segments(2048, [700, 900, 300]), dict(g7b)),
        ("hd 256, Gemma-2B heads, T=1024, window 256", packed_segments(1024, [600, 380]),
         dict(g2b, window=256)),
        ("hd 256, Gemma-2B heads, T=1024, softcap 30", packed_segments(1024, [600, 380]),
         dict(g2b, softcap=30.0)),
        ("hd 256, Gemma-7B heads, T=1024, window 256 and softcap 30",
         packed_segments(1024, [600, 380]), dict(g7b, window=256, softcap=30.0)),
        ("hd 256, Gemma-7B heads, T=1088 (17 q tiles: a block with one)",
         packed_segments(1088, [600, 450]), dict(g7b)),
        ("hd 256, Gemma-2-2B heads (Hq=8 Hkv=4), T=6144, window 4096 and softcap 50",
         packed_segments(6144, [5000, 1000]), dict(GEMMA2_HEADS, window=4096, softcap=50.0)),
        ("hd 256 f32, Gemma-2B heads, T=256", packed_segments(256, [100, 140]),
         dict(g2b, dtype=torch.float32)),
        ("hd 256 f32, Gemma-7B heads, T=256", packed_segments(256, [100, 140]),
         dict(g7b, dtype=torch.float32)),
    ]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst = {hd: dict.fromkeys(names, 0.0) for hd in fa.HEAD_DIMS}
    for i, (name, seg, kw) in enumerate(cases):
        dtype = kw.get("dtype", torch.bfloat16)
        hd = kw.get("hd", 128)
        qs, k, v, dout, sg = flash_case(200 + i, seg, dtype=dtype, Hq=kw.get("Hq", 12),
                                        Hkv=kw.get("Hkv", 2), hd=hd)
        errs = compare_flash(name, qs, k, v, dout, sg, kw.get("window"), kw.get("softcap"))
        if dtype != torch.float32:
            worst[hd] = {n: max(worst[hd][n], errs[n]) for n in names}
    return worst


# ---------------------------------------------------------------------------
# engine on the card against the engine on the CPU (small input)
# ---------------------------------------------------------------------------


def check_engine():
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    cfg = tiny_config(vocab_size=97, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                      eos_token_id=None)
    cpu_model = init_params(cfg, seed=5, device="cpu")
    gpu_model = build_model(cfg, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())

    def run(model, device):
        eng = GenEngine(cfg, params=model, n_slots=4, max_seq_len=256, prompt_bucket=16,
                        kv_dtype="float32", seed=3, device=device)
        rng = np.random.default_rng(11)
        reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, 97, n).tolist(),
                           max_new_tokens=m, temperature=0.0)
                for i, (n, m) in enumerate([(10, 6), (24, 30), (7, 12), (40, 9), (5, 20)])]
        eng.generate_blocking(reqs)
        return reqs

    for a, b in zip(run(cpu_model, "cpu"), run(gpu_model, "cuda")):
        dlp = float(np.abs(np.subtract(a.output_logprobs, b.output_logprobs)).max())
        if a.output_tokens != b.output_tokens or dlp > 1e-4:
            raise AssertionError(f"request {a.rid}: card and CPU engines disagree "
                                 f"(tokens equal {a.output_tokens == b.output_tokens}, "
                                 f"max |dlogprob| {dlp:.2e})")
    print("  greedy streams equal on card and CPU, logprobs within 1e-4")


# ---------------------------------------------------------------------------
# serving at full width
# ---------------------------------------------------------------------------


def post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def running_server(argv):
    """`areal_tpu_torch.gen.server.main(argv)` on a thread; yields the HTTP
    server and stops it (and its worker) on exit."""
    ready = threading.Event()
    holder = {}

    def on_ready(httpd):
        holder["httpd"] = httpd
        ready.set()

    def run_server():
        try:
            gen_server.main(argv, on_ready=on_ready)
        except BaseException as e:  # surfaced to the main thread below
            holder["error"] = e
            ready.set()

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    ready.wait(900)
    if "httpd" not in holder:
        raise RuntimeError(f"server did not start: {holder.get('error')!r}")
    try:
        yield holder["httpd"]
    finally:
        holder["httpd"].shutdown()
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")


def serve_qwen(ckpt_dir):
    """Drive the port's server over HTTP; returns (engine, launches,
    decode steps, wall seconds, tokens)."""
    cfg = qwen25_1p5b()
    model = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    save_hf_checkpoint(model, ckpt_dir)
    del model
    torch.cuda.empty_cache()
    print(f"  checkpoint written in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots", "16",
                         "--max-seq-len", "2048"]) as httpd:
        engine = httpd.gen.engine
        print(f"  server up (checkpoint loaded) in {time.perf_counter() - t0:.1f} s "
              f"on port {httpd.port}")
        rng = np.random.default_rng(0)
        bodies = []
        for i in range(12):
            greedy = i % 2 == 0
            sp = dict(max_new_tokens=64, min_new_tokens=64,
                      temperature=0.0 if greedy else 1.0, top_p=1.0 if greedy else 0.9)
            ids = rng.integers(0, cfg.vocab_size, int(rng.integers(64, 901))).tolist()
            bodies.append(dict(rid=f"r{i}", input_ids=ids, sampling_params=sp))
        # the batch's greedy rows and one more greedy copy form a declared
        # group of 3 over one prompt: the engine prefills it once (the
        # representative) and fans its K/V out to the other two, which take
        # the same path in the same calls, so their streams must be equal
        group = [8, 10, 11]
        for i in group:
            bodies[i].update(input_ids=list(bodies[8]["input_ids"]), group_id="g",
                             group_n=len(group), sampling_params=dict(bodies[8]["sampling_params"]))
        ragged_paged_attention.launches = ragged_paged_attention.launches_dec = 0
        steps0 = engine.stats["decode_steps"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(9) as pool:
            singles = [pool.submit(post, httpd.port, "/generate", b) for b in bodies[:8]]
            batch = pool.submit(post, httpd.port, "/generate_batch", {"requests": bodies[8:]})
            results = [f.result() for f in singles] + batch.result()["results"]
        wall = time.perf_counter() - t0
        launches = ragged_paged_attention.launches
        dec_launches = ragged_paged_attention.launches_dec
        steps = engine.stats["decode_steps"] - steps0
        health = get(httpd.port, "/health")
    for b, r in zip(bodies, results):
        lp = np.asarray(r["output_logprobs"], np.float64)
        if len(r["output_tokens"]) != 64 or len(lp) != 64:
            raise AssertionError(f"{b['rid']}: {len(r['output_tokens'])} tokens, want 64")
        if not (np.isfinite(lp).all() and (lp <= 0).all()):
            raise AssertionError(f"{b['rid']}: logprobs not finite and <= 0")
    hits = [results[i]["cache_hit_tokens"] for i in group]
    want_hit = len(bodies[8]["input_ids"]) - 1
    if sorted(hits) != [0, want_hit, want_hit]:
        raise AssertionError(f"the group's prompt was not prefilled once and shared: cache "
                             f"hits {hits}, want one 0 and two {want_hit}")
    rep, *sibs = sorted((results[i] for i in group), key=lambda r: r["cache_hit_tokens"])
    if any((r["output_tokens"], r["output_logprobs"]) != (sibs[0]["output_tokens"],
                                                          sibs[0]["output_logprobs"])
           for r in sibs):
        raise AssertionError("two greedy siblings fanned out from one representative returned "
                             "different streams")
    same = next((j for j, (a, b) in enumerate(zip(rep["output_tokens"], sibs[0]["output_tokens"]))
                 if a != b), 64)
    print(f"  a greedy group of 3 over one {len(bodies[8]['input_ids'])}-token prompt: the two "
          f"siblings (cache hits {want_hit}) bit-equal; against the representative's full "
          f"prefill: first-token logprob |diff| "
          f"{abs(rep['output_logprobs'][0] - sibs[0]['output_logprobs'][0]):.5f}, streams equal "
          f"for {same} of 64 tokens (bf16)")
    print(f"  12 requests x 64 tokens in {wall:.2f} s; health {health}")
    print(f"  kernel launches {launches} (on the decode kernel dec::ragged_dec: "
          f"{dec_launches}), decode steps {steps}, {SERVE_LAYERS} x steps = "
          f"{SERVE_LAYERS * steps}")
    if steps == 0 or launches != SERVE_LAYERS * steps:
        raise AssertionError("the serving path did not run every decode layer "
                             "through the ragged kernel")
    if dec_launches != launches:
        raise AssertionError("a bf16 decode launch of the serving path missed the decode "
                             "kernel")
    return engine, launches, steps, wall, sum(len(r["output_tokens"]) for r in results)


def decode_rate(eng, prompt=512, new=64):
    """Steady decode tokens/s of an idle engine filled to its full slot
    grid (the first step, prefill and one chunk, is not timed)."""
    n_slots = eng.n_slots
    rng = np.random.default_rng(1)
    vocab = eng.model_config.vocab_size
    reqs = [GenRequest(rid=str(i), input_ids=rng.integers(0, vocab, prompt).tolist(),
                       max_new_tokens=new, temperature=0.0) for i in range(n_slots)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # admission (prefill) + the first chunk
    torch.cuda.synchronize()
    t0, tokens = time.perf_counter(), 0
    while any(not r.stop_reason for r in reqs):
        tokens += eng.step()
    torch.cuda.synchronize()
    return tokens / (time.perf_counter() - t0)


def profile_decode(eng, prompt=512, new=64, steps=2, top=8):
    """torch.profiler over `steps` steady engine steps (decode_chunk decode
    steps each) of a full slot grid: prints the top device ops by time,
    the ragged kernel's share of device time, and the device's busy share
    of the window's wall time (the profiler slows the host, so that share
    reads low).  Returns the device ms per decode step, or None when the
    profiler saw no device time."""
    rng = np.random.default_rng(4)
    reqs = [GenRequest(rid=f"prof{i}", input_ids=rng.integers(0, 151936, prompt).tolist(),
                       max_new_tokens=new, min_new_tokens=new, temperature=0.0)
            for i in range(eng.n_slots)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # admission (prefill) + the first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    while any(not r.stop_reason for r in reqs):
        eng.step()
    kernels = device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        print("  profiler: key_averages() shows no device time on this machine")
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    print(f"  profiler window: {steps} engine steps x {eng.decode_chunk} decode steps, "
          f"{wall_us / 1e3:.2f} ms wall, {total / 1e3:.2f} ms device time")
    for e in kernels[:top]:
        t = e.self_device_time_total
        print(f"    {t / 1e3:9.3f} ms {100 * t / total:5.1f}%  x{e.count:<5d} {e.key[:90]}")
    ragged = sum(e.self_device_time_total for e in kernels if "ragged_" in e.key)
    per_step = total / 1e3 / (steps * eng.decode_chunk)
    print(f"  ragged kernels {ragged / 1e3:.3f} ms = {100 * ragged / total:.1f}% of device "
          f"time; device busy {100 * total / wall_us:.1f}% of the window's wall time; "
          f"{per_step:.3f} ms of device time per decode step")
    return per_step


# ---------------------------------------------------------------------------
# training at full width
# ---------------------------------------------------------------------------

TRAIN_PROMPTS, GROUP, NEW_TOKENS, ROW_LEN = 8, 4, 256, 1024
# mean |trainer logprob - server logprob| over the completions.  Both sides
# run bf16 on the same weights, but through different attention (naive
# prefill and the ragged kernel, probabilities rounded to bf16, against the
# flash kernels with f32 probabilities) and different head arithmetic
# (one bf16 product against vocab chunks): bf16 logits carry a relative
# rounding of 2^-8, a few hundredths on logits of a few units, so the mean
# should sit near 1e-2; 5e-2 leaves room without hiding a wrong position or
# a wrong token, which would cost whole nats.
LOGP_MEAN_TOL = 5e-2


def flash_counts():
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)


def flash_counts_tc():
    return (fa.flash_fwd.launches_tc, fa.flash_bwd_dq.launches_tc,
            fa.flash_bwd_dkv.launches_tc)


def reset_flash_counts():
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = w.launches_tc = 0
        w.launches_hd = dict.fromkeys(fa.HEAD_DIMS, 0)


# kernel groups of the train profile, by substrings of the kernel's name
# (first match wins; the rest is "other")
TRAIN_OP_GROUPS = (
    ("flash attention", ("flash_",)),
    ("decode attention", ("ragged_",)),
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce",)),
)
FLASH_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")


def report_train_profile(prof, wall_us, what, top=12):
    """Prints the top device ops of a profiled window (`what` says which)
    with their shares of device time, the groups of TRAIN_OP_GROUPS, each
    flash kernel's share, the kernel launches, and the device's busy share
    of the window's wall time."""
    kernels = device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        print("  profiler: key_averages() shows no device time on this machine")
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    print(f"  profiler window: {what}, {wall_us / 1e3:.2f} ms wall, {total / 1e3:.2f} ms "
          f"device time in {sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        t = e.self_device_time_total
        print(f"    {t / 1e3:9.3f} ms {100 * t / total:5.1f}%  x{e.count:<6d} {e.key[:90]}")
    groups = {}
    for e in kernels:
        name = e.key.lower()
        label = next((lab for lab, keys in TRAIN_OP_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[label] = groups.get(label, 0.0) + e.self_device_time_total
    print("  by group: " + ", ".join(
        f"{lab} {t / 1e3:.2f} ms ({100 * t / total:.1f}%)"
        for lab, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    flash = [(n, sum(e.self_device_time_total for e in kernels if n in e.key))
             for n in FLASH_KERNELS]
    print("  flash kernels: " + ", ".join(
        f"{n} {t / 1e3:.2f} ms ({100 * t / total:.1f}%)" for n, t in flash))
    print(f"  device busy {100 * total / wall_us:.1f}% of the window's wall time")


def rollout_batch(results, prompts, rewards):
    """Padded, token-aligned training batch from the server's answers."""
    seqs = [p + r["output_tokens"] for p, r in zip(prompts, results)]
    B, L = len(seqs), max(len(x) for x in seqs)
    batch = {
        "input_ids": np.zeros((B, L), np.int32),
        "attention_mask": np.zeros((B, L), bool),
        "loss_mask": np.zeros((B, L), np.float32),
        "logprobs": np.zeros((B, L), np.float32),
        "rewards": np.asarray(rewards, np.float32),
    }
    for i, (p, r) in enumerate(zip(prompts, results)):
        n, P = len(seqs[i]), len(p)
        batch["input_ids"][i, :n] = seqs[i]
        batch["attention_mask"][i, :n] = True
        batch["loss_mask"][i, P:n] = 1.0
        batch["logprobs"][i, P:n] = r["output_logprobs"]
    return batch


def train_qwen(ckpt_dir, publish_dir):
    """The training half of the main path at full width: rollouts from the
    port's server, the PPO actor's logprobs, advantages and updates, and
    the new weights published back to the server.  Returns the flash
    launch counts of the whole phase, the stats of the unprofiled updates'
    train_batch calls and the packed segment ids of one training
    micro-batch."""
    cfg = qwen25_1p5b()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(128, 513))).tolist()
               for _ in range(TRAIN_PROMPTS)]
    reset_flash_counts()
    counts = np.zeros(3, np.int64)
    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots",
                         str(TRAIN_PROMPTS * GROUP), "--max-seq-len", str(ROW_LEN)]) as httpd:
        port = httpd.port
        print(f"  server up in {time.perf_counter() - t0:.1f} s")

        # 1. rollouts: 8 prompts x group 4 over HTTP
        sp = dict(max_new_tokens=NEW_TOKENS, min_new_tokens=NEW_TOKENS, temperature=1.0,
                  top_p=1.0)
        bodies = [dict(rid=f"p{i}g{j}", input_ids=p, sampling_params=sp)
                  for i, p in enumerate(prompts) for j in range(GROUP)]
        t0 = time.perf_counter()
        results = post(port, "/generate_batch", {"requests": bodies})["results"]
        wall = time.perf_counter() - t0
        n_tok = sum(len(r["output_tokens"]) for r in results)
        if any(len(r["output_tokens"]) != NEW_TOKENS for r in results):
            raise AssertionError("a rollout did not return 256 tokens")
        print(f"  rollouts: {len(results)} x {NEW_TOKENS} tokens in {wall:.2f} s "
              f"({n_tok / wall:.1f} tokens/s)")

        # 2. reward: 1 when most completion ids are even
        rewards = [float(np.mean(np.asarray(r["output_tokens"]) % 2 == 0) > 0.5)
                   for r in results]
        batch = rollout_batch(results, [b["input_ids"] for b in bodies], rewards)
        print(f"  batch {batch['input_ids'].shape}, {int(batch['attention_mask'].sum())} "
              f"tokens, mean reward {np.mean(rewards):.3f}")

        # 3. the actor on the same checkpoint: f32 masters, bf16 compute
        t0 = time.perf_counter()
        actor = TorchPPOActor(PPOActorConfig(
            init_from_scratch=False,
            path=ckpt_dir, dtype="bfloat16", gradient_checkpointing=True,
            group_size=GROUP, ppo_n_minibatches=2, use_decoupled_loss=True,
            recompute_logprob=True, pack_length_quantum=ROW_LEN, max_pack_length=ROW_LEN,
            adv_norm=NormConfig(mean_level="group", std_level="group"),
            optimizer=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ))
        actor.initialize(ft_spec=FinetuneSpec(1, len(bodies), len(bodies)))
        torch.cuda.synchronize()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card")

        # 4. logprobs: trainer against server on the completion tokens
        t0 = time.perf_counter()
        before = flash_counts()
        batch["prox_logp"] = actor.compute_logp(batch)
        got = tuple(int(x) for x in np.subtract(flash_counts(), before))
        print(f"  compute_logp in {time.perf_counter() - t0:.2f} s; flash launches "
              f"fwd/dq/dkv {got}")
        if got != (SERVE_LAYERS, 0, 0):
            raise AssertionError("compute_logp did not run 28 flash forwards")
        counts += got
        mask = batch["loss_mask"] > 0
        served = np.roll(batch["logprobs"], -1, axis=-1)[np.roll(mask, -1, axis=-1)]
        mine = batch["prox_logp"][np.roll(mask, -1, axis=-1)]
        dlp = np.abs(mine - served)
        print(f"  |trainer - server| logprob: max {dlp.max():.4f}, mean {dlp.mean():.4f} "
              f"(tolerance on the mean {LOGP_MEAN_TOL})")
        if not np.isfinite(mine).all() or dlp.mean() > LOGP_MEAN_TOL:
            raise AssertionError("trainer logprobs disagree with the server's")

        # 5. advantages and 3 PPO updates
        actor.compute_advantages(batch)
        view = {k: batch[k] for k in actor.actor.LOSS_KEYS if k in batch}
        mbs = split_padded_tensor_dict_into_mb_list(
            view, n_mbs=actor.config.ppo_n_minibatches).mbs  # as ppo_update splits
        mb_tokens = [int(mb["attention_mask"].sum()) for mb in mbs]
        seg_rows = actor._prepare_rows(mbs[0], actor.config.mb_spec.n_mbs)[1]["segment_ids"]
        stats = []
        for step in range(3):
            before = flash_counts()
            profiled = step == 2  # the third update runs in a profiler window
            prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                    else contextlib.nullcontext())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prof:
                st = actor.ppo_update(batch)
                torch.cuda.synchronize()
                # before the profiler's exit, which processes its events
                wall_us = (time.perf_counter() - t0) * 1e6
            got = tuple(int(x) for x in np.subtract(flash_counts(), before))
            n_mb = len(st) * actor.config.mb_spec.n_mbs
            want = (2 * SERVE_LAYERS * n_mb, SERVE_LAYERS * n_mb, SERVE_LAYERS * n_mb)
            for s_, toks in zip(st, mb_tokens):
                s_["tokens_per_s"] = toks / s_["step_time"]
                print(f"  update {step}: loss {s_['loss']:+.5f} grad_norm "
                      f"{s_['grad_norm']:.4f} step_time {s_['step_time']:.3f} s "
                      f"train tokens/s {s_['tokens_per_s']:.1f} "
                      f"mfu {s_.get('mfu', float('nan')):.4f}"
                      + (" (profiled)" if profiled else ""))
                if not all(np.isfinite(s_[k]) for k in ("loss", "grad_norm", "step_time")):
                    raise AssertionError("a PPO step returned a non-finite stat")
            print(f"    flash launches fwd/dq/dkv {got}, want {want} "
                  f"({n_mb} micro-batches)")
            if got != want:
                raise AssertionError("a training layer's attention missed the flash kernels")
            if profiled:
                report_train_profile(prof, wall_us,
                                     f"the third update, {len(st)} train_batch calls")
            else:
                stats += st
            counts += got
        steady = stats[1:]  # the first train_batch warms the allocator and AdamW's state
        print("  unprofiled train_batch after the first: step_time " + ", ".join(
            f"{s_['step_time']:.3f}" for s_ in steady) + " s (median "
            f"{np.median([s_['step_time'] for s_ in steady]):.3f}); mfu " + ", ".join(
            f"{s_.get('mfu', float('nan')):.4f}" for s_ in steady))

        # 6. the policy moved along the advantages
        before = flash_counts()
        new_logp = actor.compute_logp(batch)
        counts += np.subtract(flash_counts(), before)
        lm = batch["loss_mask"] > 0
        gain = float(np.sum((batch["advantages"] * (new_logp - batch["prox_logp"]))[lm]))
        print(f"  sum adv * (logp_new - logp_prox) over the loss mask: {gain:.4f}")
        if not gain > 0:
            raise AssertionError("the updates did not move the policy along the advantages")

        # 7. publish: disk snapshot -> /update_weights_from_disk
        actor.set_version(1)
        t0 = time.perf_counter()
        actor.update_weights(WeightUpdateMeta(type="disk", path=publish_dir))
        reply = post(port, "/update_weights_from_disk", {"path": publish_dir, "version": 1})
        health = get(port, "/health")
        print(f"  published and reloaded in {time.perf_counter() - t0:.1f} s: {reply}, "
              f"server version {health['version']}")
        if reply.get("version") != actor.get_version() or health["version"] != 1:
            raise AssertionError("the server did not take the trainer's version")
        snap = dict(safetensors_io.iter_safetensors(os.path.join(publish_dir, "v1")))
        params = dict(actor.model.named_parameters())
        if set(snap) != set(params) or not all(
                torch.equal(snap[n].to(p.device), p.detach().to(torch.bfloat16))
                for n, p in params.items()):
            raise AssertionError("the snapshot is not the trainer's params in bf16")
        print(f"  snapshot equals the trainer's {len(params)} params in bf16, bit for bit")
        out = post(port, "/generate", dict(input_ids=prompts[0], sampling_params=dict(
            max_new_tokens=64, min_new_tokens=64, temperature=0.0)))
        lp = np.asarray(out["output_logprobs"])
        if len(out["output_tokens"]) != 64 or not np.isfinite(lp).all() or out["version"] != 1:
            raise AssertionError("the reloaded server did not answer a greedy request")
        print(f"  greedy request on the new weights: 64 tokens, version {out['version']}")
    actor.destroy()
    del actor
    torch.cuda.empty_cache()
    return tuple(int(c) for c in counts), stats, seg_rows


# ---------------------------------------------------------------------------
# the colocated GRPO loop at full width
# ---------------------------------------------------------------------------

GRPO_SLOTS, GRPO_SEQ = 32, 1024
GRPO_PROMPT_LEN = (64, 256)
# the bench's --len-jitter: budgets log-uniform in [256 / (1 + 3), 256]
GRPO_LEN_JITTER = 3.0


def print_prefill(res, indent="    "):
    """A mode's prefill accounting and its requests' latency percentiles."""
    pf, lat = res["prefill"], res["latency"]
    print(f"{indent}prefill tokens: cold {pf['prefill_tokens']}, shared {pf['shared_tokens']}, "
          f"suffix {pf['suffix_tokens']}, reused {pf['reused_tokens']}; fan-out copies "
          f"{pf['copy_calls']}")
    if lat:
        print(f"{indent}latency over {lat['n']} requests (warmup included: "
              f"{lat['includes_warmup']}): " + "; ".join(
                  f"{k} p50 {lat[k]['p50']:.4f} p99 {lat[k]['p99']:.4f}"
                  for k in ("ttft_s", "e2e_s", "inter_token_s") if lat[k]))
    if pf["shared_tokens"] <= 0:
        raise AssertionError("no group shared its prompt's prefill in this mode")


# (label, mode, timed steps, warmup steps, interrupting publish)
GRPO_PLANS = (("sync", "sync", 1, 1, False), ("async", "async", 1, 1, False),
              ("interrupt", "async", 1, 0, True))


def grpo_loop(ckpt_dir, model="qwen2.5-1.5b", plans=GRPO_PLANS):
    """The asynchronous GRPO loop of the port's bench module on one card,
    trainer and server colocated in this process, from the HF checkpoint
    `ckpt_dir` (its config.json sets the model; `model` labels it): sync
    (rollout_batch, train_phase with the serving memory released,
    publish_weights), async (WorkflowExecutor.prepare_batch under the
    staleness gate, a live publish after each step) and, in the grpo
    phase's plans, one async step with an interrupting publish, profiled.
    The reward is the parity of the last token, which varies within a
    group, so the updates move the weights and the served-weights check can
    fail.  Then the ragged kernel on the loop's decode grid (32 slots) and
    the flash kernels on the packed rows of one of its train batches, at
    the model's heads, against their plain versions.  Returns the launches
    of every kernel over the loop, those comparisons' |kernel - plain|, the
    mode results and the packed segment ids of the last train batch."""
    from areal_tpu_torch.api.config import GenerationHyperparameters
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.scripts import bench_e2e_grpo as bench
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    t0 = time.perf_counter()
    actor, serving, cfg = bench._make_parts(model, GRPO_SLOTS, GRPO_SEQ, GROUP,
                                            model_path=ckpt_dir)
    L = cfg.num_layers
    heads = dict(Hq=cfg.num_heads, Hkv=cfg.num_kv_heads, hd=cfg.head_dim_)
    prewarm_reward_pool()
    torch.cuda.synchronize()
    print(f"  trainer and colocated server up in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card")
    recorder = bench._LatencyRecorder()
    workflow = bench._RecordingWorkflow(RLVRWorkflow(
        reward_fn=bench._reward_last_even, gconfig=GenerationHyperparameters(
            n_samples=GROUP, max_new_tokens=NEW_TOKENS, temperature=1.0)), recorder)
    dataset = bench.make_dataset(256, cfg.vocab_size, GRPO_PROMPT_LEN[1], GRPO_PROMPT_LEN[0],
                                 len_jitter=GRPO_LEN_JITTER, max_new_tokens=NEW_TOKENS)
    runs, launches = {}, np.zeros(4, np.int64)
    served0 = {n: p.detach().clone() for n, p in serving.engine.model.named_parameters()}
    packed = []  # segment ids of every row-packed train batch
    prepare_rows = actor._prepare_rows

    def recording_prepare_rows(batch, n_mbs):
        rp, data, row_len = prepare_rows(batch, n_mbs)
        packed.append(data["segment_ids"])
        return rp, data, row_len

    actor._prepare_rows = recording_prepare_rows
    try:
        reset_flash_counts()
        ragged_paged_attention.launches = 0
        for label, mode, n_timed, warmup, interrupt in plans:
            before = np.array([ragged_paged_attention.launches, *flash_counts()])
            steps0 = serving.engine.stats["decode_steps"]
            # the last run goes through a profiler window (CUDA only)
            prof = (profile(activities=[ProfilerActivity.CUDA]) if label == "interrupt"
                    else contextlib.nullcontext())
            t0 = time.perf_counter()
            with prof:
                res = bench.run_mode(
                    mode, actor, serving, workflow, dataset, TRAIN_PROMPTS, n_timed,
                    warmup=warmup, interrupt_publish=interrupt, recorder=recorder)
                torch.cuda.synchronize()
                # before the profiler's exit, which processes its events
                wall_us = (time.perf_counter() - t0) * 1e6
            got = np.array([ragged_paged_attention.launches, *flash_counts()]) - before
            steps = serving.engine.stats["decode_steps"] - steps0
            n_steps = n_timed + warmup
            runs[label] = res
            launches += got
            print(f"  {label} ({res['publish']} publish): {res['trajs_per_sec_per_chip']:.4f} "
                  f"trajectories/s/chip, {res['effective_tokens_per_sec_per_chip']:.1f} "
                  f"effective tokens/s/chip over {res['steps']} timed steps "
                  f"({res['trajectories']} trajectories, {res['wall_s']:.2f} s); "
                  f"reward mean {res['reward_mean']:.3f}")
            print("    per step: rollout wait " + ", ".join(f"{x:.3f}" for x in res["rollout_s"])
                  + " s; train " + ", ".join(f"{x:.3f}" for x in res["train_s"]) + " s")
            print("    pause windows " + ", ".join(f"{x * 1e3:.3f}" for x in
                                                      res["pause_window_s"])
                  + " ms; serving copies exported in " + ", ".join(
                      f"{x * 1e3:.3f}" for x in res["export_s"]) + " ms")
            print(f"    version lag (trainer - oldest token) over {n_steps} consumed batches: "
                  f"{res['version_lag_hist']}; newest token - trainer version at most "
                  f"{res['max_version_ahead']}")
            print(f"    |trainer - server| logprob on same-version tokens: mean "
                  f"{res['same_version_logp_gap_mean']:.4f} over {res['same_version_tokens']} "
                  f"tokens (tolerance {LOGP_MEAN_TOL}); losses "
                  + ", ".join(f"{x:+.5f}" for x in res["loss_trajectory"]))
            print(f"    launches: ragged {got[0]} = {L} x {steps} decode steps; "
                  f"flash fwd/dq/dkv {tuple(int(x) for x in got[1:])} over {n_steps} steps")
            if "ledger" in res:
                print(f"    staleness ledger {res['ledger']}")
            print_prefill(res)
            if label == "interrupt":
                report_train_profile(prof, wall_us, f"the {label} run (profiled), {steps} "
                                     "decode steps and one logprob pass and update")
            if got[0] != L * steps or steps == 0:
                raise AssertionError(f"{label}: ragged launches != {L} x decode steps")
            if tuple(got[1:]) != (3 * L * n_steps, L * n_steps, L * n_steps):
                raise AssertionError(f"{label}: a logprob pass or an update missed the "
                                     "flash kernels")
            if res["max_version_ahead"] > 0:
                raise AssertionError(f"{label}: a consumed token comes from a version above "
                                     "the trainer's")
            led = res.get("ledger")
            if led and led["submitted"] != led["accepted"] + led["rejected"] + led["running"]:
                raise AssertionError(f"{label}: the staleness ledger does not balance")
            if (res["same_version_tokens"] == 0
                    or not res["same_version_logp_gap_mean"] <= LOGP_MEAN_TOL):
                raise AssertionError(f"{label}: trainer logprobs disagree with the server's")
            if res["reward_timeouts"] or res["reward_failures"]:
                raise AssertionError(f"{label}: {res['reward_timeouts']} reward timeouts, "
                                     f"{res['reward_failures']} failures")
            if not all(np.isfinite(res["loss_trajectory"])):
                raise AssertionError(f"{label}: a non-finite loss")
        on_tc = flash_counts_tc()
        if on_tc != flash_counts():
            raise AssertionError("a bf16 flash launch of the grpo phase missed its "
                                 "tensor-core kernel")
        served = dict(serving.engine.model.named_parameters())
        if serving.get_version() != actor.get_version() or not all(
                torch.equal(served[n], p.detach().to(torch.bfloat16))
                for n, p in actor.model.named_parameters()):
            raise AssertionError("the served weights are not the trainer's bf16 cast")
        moved = [n for n, p in served.items() if not torch.equal(p, served0[n])]
        n_moved = sum(int((p != served0[n]).sum()) for n, p in served.items())
        print(f"  after the last publish (version {serving.get_version()}) the served weights "
              f"equal the trainer's {len(served)} params in bf16, bit for bit; "
              f"{len(moved)} of them ({n_moved} elements) differ from the phase's start")
        if not moved:
            raise AssertionError("no served weight changed over the phase: the updates "
                                 "never reached the server")
        del served0
        print(f"  {model}: async / sync trajectories/s: "
              f"{runs['async']['trajs_per_sec_per_chip'] / runs['sync']['trajs_per_sec_per_chip']:.4f}")
        n_all = sum(n_timed + warmup for _, _, n_timed, warmup, _ in plans)
        print(f"  launches over the phase ({n_all} GRPO steps): ragged {launches[0]}, flash "
              f"fwd/dq/dkv {tuple(int(x) for x in launches[1:])}, on the tensor cores {on_tc}")
        # the kernels at the phase's own shapes, after its counted window
        lengths = torch.from_numpy(np.random.default_rng(3).integers(
            GRPO_PROMPT_LEN[0], GRPO_PROMPT_LEN[1] + NEW_TOKENS, GRPO_SLOTS)).to(torch.int32)
        errs = {"ragged_paged_attention": compare_ragged(
            f"{model} decode grid (B={GRPO_SLOTS} T=1 K={GRPO_SEQ}, spans "
            f"{GRPO_PROMPT_LEN[0]}..{GRPO_PROMPT_LEN[1] + NEW_TOKENS - 1})",
            ragged_case(9, B=GRPO_SLOTS, K=GRPO_SEQ, M=GRPO_SEQ, lengths=lengths, **heads))}
        seg = torch.from_numpy(np.ascontiguousarray(packed[-1])).to(torch.int32)
        errs.update(compare_flash(f"{model} train rows {tuple(seg.shape)}",
                                  *flash_case(301, seg, Hq=heads["Hq"], Hkv=heads["Hkv"])))
    finally:
        actor._prepare_rows = prepare_rows
        serving.destroy()
        shutdown_reward_pool()
        actor.destroy()
        del actor, serving
        torch.cuda.empty_cache()
    return tuple(int(x) for x in launches), errs, runs, packed[-1]


# ---------------------------------------------------------------------------
# prefix reuse and group fan-out at full width
# ---------------------------------------------------------------------------

PREFIX_NEW = 32  # tokens decoded per request after the admission
PREFIX_F32_LAYERS = 4
# the bf16 runs with sharing on and off, against each other: a sibling's
# first token comes from logits computed over its representative's copied
# K/V by the suffix prefill, against its own full prefill; both are bf16 on
# the same weights with the same sampler keys, so they differ by bf16
# rounding only (the trainer-against-server gap, through more different
# paths, sits near 0.016: LOGP_MEAN_TOL).  A first token may flip where
# two candidates sit within that rounding; at most 4 of 32 may.
FIRST_LOGP_MEAN_TOL, FIRST_LOGP_MAX_TOL, FIRST_TOKEN_FLIPS = LOGP_MEAN_TOL, 0.25, 4


def prefix_requests(prompts, new, temperature, tag):
    """GROUP siblings per prompt, each declaring its group, streams pinned
    (so a stream does not depend on the run it is in)."""
    return [GenRequest(rid=f"{tag}{i}-{k}", input_ids=list(p), max_new_tokens=new,
                       temperature=temperature, group_id=f"{tag}{i}", group_n=GROUP,
                       stream_id=1 + GROUP * i + k)
            for i, p in enumerate(prompts) for k in range(GROUP)]


def prefix_run(model, prompts, share, temperature, kv_dtype, label):
    """The groups admitted in one pass by an engine of the grpo cell (32
    slots, max_seq_len 1024), three times on fresh engines: once to warm
    the pass's shapes, once under torch.profiler (its device time), once
    timed on the host clock and then decoded to the end.  Returns (that
    engine, its requests, the ragged kernel's launches in its decode,
    (admission wall ms, admission device ms))."""
    cfg = model.cfg

    def submitted():
        eng = GenEngine(cfg, params=model, n_slots=GRPO_SLOTS, max_seq_len=GRPO_SEQ,
                        prompt_bucket=128, kv_dtype=kv_dtype, seed=0, share_prefix=share)
        reqs = prefix_requests(prompts, PREFIX_NEW, temperature, "p")
        eng.submit_batch(reqs)
        torch.cuda.synchronize()
        return eng, reqs

    with torch.no_grad():  # the admission pass of step(), alone
        eng, _ = submitted()
        eng._admit()
        eng.abort_all()
        eng, _ = submitted()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng._admit()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
        if dev <= 0:
            raise AssertionError(f"{label}: the profiler saw no device time in the admission")
        eng.abort_all()
        eng, reqs = submitted()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_prompt = sum(len(r.input_ids) for r in reqs)
    launches0 = ragged_paged_attention.launches
    while any(not r.stop_reason for r in reqs):
        eng.step()
    launches = ragged_paged_attention.launches - launches0
    st = eng.stats
    acct = {k: st[k] for k in ("prefill_tokens", "shared_tokens", "suffix_tokens",
                               "reused_tokens", "copy_calls")}
    print(f"  {label}: {len(reqs)} requests, {n_prompt} prompt tokens; cold "
          f"{acct['prefill_tokens']}, shared {acct['shared_tokens']}, suffix "
          f"{acct['suffix_tokens']}, reused {acct['reused_tokens']}, copies "
          f"{acct['copy_calls']}; admission {1e3 * wall:.2f} ms of wall, {dev:.3f} ms of "
          f"device time; ragged {launches} = {cfg.num_layers} x {st['decode_steps']} decode "
          "steps")
    if sum(acct[k] for k in ("prefill_tokens", "shared_tokens", "suffix_tokens",
                             "reused_tokens")) != n_prompt:
        raise AssertionError(f"{label}: cold + shared + suffix + reused != prompt tokens")
    if (acct["shared_tokens"] > 0) != share:
        raise AssertionError(f"{label}: shared tokens {acct['shared_tokens']} with sharing "
                             f"{'on' if share else 'off'}")
    if launches != cfg.num_layers * st["decode_steps"] or not launches:
        raise AssertionError(f"{label}: ragged launches != layers x decode steps")
    return eng, reqs, launches, (1e3 * wall, dev)


def prefix_qwen():
    """KV prefix reuse and group fan-out on Qwen2.5-1.5B at full width
    (random weights from seed 0), in the grpo cell's engine: 8 prompts of
    64..256 tokens x group 4, groups declared and streams pinned.

    - bf16, 28 layers, sampled: sharing on against off (the token
      accounting of each, its admission's wall and device time; first-token
      logprobs against each other within FIRST_LOGP_*);
    - f32 KV and weights at 4 layers of full width, greedy: streams with
      sharing on equal those with it off, and an abort_all after the first
      decode chunk, resubmitted with the accumulated tokens, reuses the
      retained prefixes and resumes each stream exactly.
    Returns the ragged kernel's launches over the phase."""
    cfg = qwen25_1p5b().replace(eos_token_id=None)
    rng = np.random.default_rng(21)
    lo, hi = GRPO_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(TRAIN_PROMPTS)]
    launches = 0
    model = init_params(cfg, 0, "cuda")
    runs, times = {}, {}
    for share in (True, False):
        label = f"bf16 {cfg.num_layers} layers, sharing {'on' if share else 'off'}"
        eng, reqs, n, times[share] = prefix_run(model, prompts, share, 1.0, "bfloat16", label)
        runs[share] = reqs
        launches += n
        del eng
    print(f"  admission, sharing on / off: wall {times[True][0] / times[False][0]:.3f}, "
          f"device time {times[True][1] / times[False][1]:.3f}")
    same = [(a.output_logprobs[0], b.output_logprobs[0])
            for a, b in zip(runs[True], runs[False]) if a.output_tokens[0] == b.output_tokens[0]]
    flips = len(runs[True]) - len(same)
    gaps = np.abs(np.subtract(*zip(*same))) if same else np.array([np.inf])
    print(f"  first tokens equal in {len(same)} of {len(runs[True])} requests; their "
          f"logprobs on against off: mean |diff| {gaps.mean():.5f}, max {gaps.max():.5f} "
          f"(tolerance {FIRST_LOGP_MEAN_TOL} / {FIRST_LOGP_MAX_TOL}, at most "
          f"{FIRST_TOKEN_FLIPS} flips)")
    if (flips > FIRST_TOKEN_FLIPS or gaps.mean() > FIRST_LOGP_MEAN_TOL
            or gaps.max() > FIRST_LOGP_MAX_TOL):
        raise AssertionError("first tokens with sharing on and off disagree beyond bf16")
    del model, runs
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg4 = cfg.replace(num_layers=PREFIX_F32_LAYERS, dtype="float32")
    model = init_params(cfg4, 0, "cuda")
    streams = {}
    for share in (True, False):
        label = f"f32 {PREFIX_F32_LAYERS} layers, greedy, sharing {'on' if share else 'off'}"
        eng, reqs, n, _ = prefix_run(model, prompts, share, 0.0, "float32", label)
        streams[share] = [r.output_tokens for r in reqs]
        launches += n
        del eng
    if streams[True] != streams[False]:
        raise AssertionError("f32 greedy streams differ between sharing on and off")
    print(f"  f32 greedy streams with sharing on equal those with it off "
          f"({len(streams[True])} x {PREFIX_NEW} tokens)")
    # an interruption: abort after the first decode chunk, resubmit
    eng = GenEngine(cfg4, params=model, n_slots=GRPO_SLOTS, max_seq_len=GRPO_SEQ,
                    prompt_bucket=128, kv_dtype="float32", seed=0)
    first = prefix_requests(prompts, PREFIX_NEW, 0.0, "p")
    eng.submit_batch(first)
    launches0 = ragged_paged_attention.launches
    eng.step()
    eng.abort_all("abort")
    got = [len(r.output_tokens) for r in first]
    resumed = [GenRequest(rid=r.rid, input_ids=r.input_ids + r.output_tokens,
                          max_new_tokens=PREFIX_NEW - len(r.output_tokens), temperature=0.0,
                          group_id=r.group_id, group_n=r.group_n, stream_id=r.stream_id)
               for r in first]
    reused0 = eng.stats["reused_tokens"]
    eng.generate_blocking(resumed)
    n = ragged_paged_attention.launches - launches0
    launches += n
    reused = eng.stats["reused_tokens"] - reused0
    print(f"  interruption: aborted after {min(got)}..{max(got)} tokens, {len(resumed)} "
          f"resubmits reused {reused} retained tokens (cache hits "
          f"{sum(r.cache_hit_tokens for r in resumed)}), suffix "
          f"{eng.stats['suffix_tokens']}; ragged {n} = {PREFIX_F32_LAYERS} x "
          f"{eng.stats['decode_steps']} decode steps")
    if reused <= 0 or any(r.stop_reason != "length" for r in resumed):
        raise AssertionError("the resubmits after the abort did not reuse their prefixes")
    if [a.output_tokens + b.output_tokens for a, b in zip(first, resumed)] != streams[True]:
        raise AssertionError("a resumed f32 greedy stream differs from the uninterrupted one")
    if n != PREFIX_F32_LAYERS * eng.stats["decode_steps"]:
        raise AssertionError("interruption: ragged launches != layers x decode steps")
    print("  every resumed f32 greedy stream equals the uninterrupted one")
    del eng, model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the remote GRPO loop: trainer here, server a process of its own
# ---------------------------------------------------------------------------

REMOTE_EQUAL_PROMPTS, REMOTE_EQUAL_TOKENS = 4, 32


def greedy_streams(generate, vocab_size):
    """(tokens, logprobs) of REMOTE_EQUAL_PROMPTS greedy requests sent one at
    a time through `generate(body) -> wire result`."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(REMOTE_EQUAL_PROMPTS):
        body = dict(rid=f"eq{i}", input_ids=rng.integers(
            0, vocab_size, int(rng.integers(*GRPO_PROMPT_LEN))).tolist(),
            sampling_params=dict(max_new_tokens=REMOTE_EQUAL_TOKENS,
                                 min_new_tokens=REMOTE_EQUAL_TOKENS, temperature=0.0))
        r = generate(body)
        out.append((r["output_tokens"], r["output_logprobs"]))
    return out


# depth of the colocated, remote and router loops' checkpoint (full width)
REMOTE_LAYERS = 4
# depth of the spec servers' and the ppo loop's checkpoint (full width),
# written in the spec phase and kept for the ppo phase
SPEC_PPO_LAYERS = 8
QWEN3_LOOP_LAYERS = 4  # depth of the Qwen3-1.7B loop's checkpoint (full width)


def remote_qwen(ckpt_dir, publish_dir):
    """The remote GRPO loop of the bench module at full width: the port
    server on the card as a separate process (the launch helper, 32 slots,
    max_seq_len 1024, bf16, from a Qwen2.5-1.5B checkpoint of
    REMOTE_LAYERS layers), the trainer (f32 masters) in this process.  Sync with the disk publish, async with the
    transfer publish and a live commit, one async step with an aborting
    commit.  Checks the server's ragged launches (read over HTTP) against
    its decode steps, the trainer's flash launches per step, the ledger,
    versions, logprob gap, rewards, lost trajectories, and, after the last
    publish, greedy streams from the server against a GenEngine built here
    from the trainer's bf16 export.  Returns (ragged launches, flash
    launches) over the phase."""
    from areal_tpu_torch.api.config import GenerationHyperparameters, GenServerConfig
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.launcher.local import LocalLauncher
    from areal_tpu_torch.scripts import bench_e2e_grpo as bench
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launcher = LocalLauncher(os.path.join(ROOT, "build", "remote_logs"))
    try:
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=ckpt_dir, dtype="bfloat16", max_seqs=GRPO_SLOTS,
            max_context_len=GRPO_SEQ, page_size=128, random_seed=0))[0]
        print(f"  server process up at {addr} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        actor, cfg = bench._make_actor("qwen2.5-1.5b", GRPO_SEQ, GROUP, model_path=ckpt_dir)
        L = cfg.num_layers
        prewarm_reward_pool()
        torch.cuda.synchronize()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated by this process")
        recorder = bench._LatencyRecorder()
        workflow = bench._RecordingWorkflow(RLVRWorkflow(
            reward_fn=bench._reward_last_even, gconfig=GenerationHyperparameters(
                n_samples=GROUP, max_new_tokens=NEW_TOKENS, temperature=1.0)), recorder)
        dataset = bench.make_dataset(256, cfg.vocab_size, GRPO_PROMPT_LEN[1],
                                     GRPO_PROMPT_LEN[0])
        disk = WeightUpdateMeta(type="disk", path=publish_dir)
        # (label, mode, publish, timed steps, warmup steps)
        plans = (("sync", "sync", disk, 1, 1),
                 ("async", "async", WeightUpdateMeta.from_transfer(live_commit=True), 1, 1),
                 ("abort", "async", WeightUpdateMeta.from_transfer(live_commit=False), 1, 0))
        launches = np.zeros(4, np.int64)
        reset_flash_counts()
        for label, mode, meta, n_timed, warmup in plans:
            m0 = bench.server_metrics(addr)
            before = np.array(flash_counts())
            res = bench.run_mode_remote(mode, actor, meta, workflow, dataset, TRAIN_PROMPTS,
                                        n_timed, warmup=warmup, recorder=recorder)
            m1 = bench.server_metrics(addr)
            got = np.array([m1["ragged_kernel_launches"] - m0["ragged_kernel_launches"],
                            *(np.array(flash_counts()) - before)])
            steps = m1["decode_steps"] - m0["decode_steps"]
            n_steps = n_timed + warmup
            launches += got
            print(f"  {label} ({res['publish']} publish): {res['trajs_per_sec_per_chip']:.4f} "
                  f"trajectories/s/chip, {res['effective_tokens_per_sec_per_chip']:.1f} "
                  f"effective tokens/s/chip over {res['steps']} timed steps "
                  f"({res['trajectories']} trajectories, {res['wall_s']:.2f} s); "
                  f"reward mean {res['reward_mean']:.3f}, mean |advantage| per step "
                  + ", ".join(f"{x:.4f}" for x in res["adv_abs_mean"]))
            print("    per step: rollout wait " + ", ".join(f"{x:.3f}" for x in res["rollout_s"])
                  + " s; train " + ", ".join(f"{x:.3f}" for x in res["train_s"]) + " s")
            print("    publish: stage " + ", ".join(f"{x * 1e3:.1f}" for x in res["stage_s"])
                  + " ms; commit " + ", ".join(f"{x * 1e3:.1f}" for x in res["commit_s"])
                  + " ms; server pause windows " + ", ".join(
                      f"{x * 1e3:.3f}" for x in res["pause_window_s"]) + " ms")
            print(f"    version lag (trainer - oldest token) over {n_steps} consumed batches: "
                  f"{res['version_lag_hist']}; newest token - trainer version at most "
                  f"{res['max_version_ahead']}; server at version {res['server_version']}")
            print(f"    |trainer - server| logprob on same-version tokens: mean "
                  f"{res['same_version_logp_gap_mean']:.4f} over {res['same_version_tokens']} "
                  f"tokens (tolerance {LOGP_MEAN_TOL}); losses "
                  + ", ".join(f"{x:+.5f}" for x in res["loss_trajectory"]))
            print(f"    server: ragged {got[0]} = {L} x {steps} decode steps; "
                  f"trainer: flash fwd/dq/dkv {tuple(int(x) for x in got[1:])} over {n_steps} "
                  f"steps; staleness ledger {res['ledger']}; lost trajectories "
                  f"{res['lost_trajectories']}")
            print_prefill(res)  # the server's /metrics, read over HTTP
            if got[0] != L * steps or steps == 0:
                raise AssertionError(f"remote {label}: server ragged launches != {L} x decode "
                                     "steps")
            if tuple(got[1:]) != (3 * L * n_steps, L * n_steps, L * n_steps):
                raise AssertionError(f"remote {label}: a logprob pass or an update missed the "
                                     "flash kernels")
            if res["max_version_ahead"] > 0:
                raise AssertionError(f"remote {label}: a consumed token comes from a version "
                                     "above the trainer's")
            led = res["ledger"]
            if led["submitted"] != led["accepted"] + led["rejected"] + led["running"]:
                raise AssertionError(f"remote {label}: the staleness ledger does not balance")
            if res["lost_trajectories"]:
                raise AssertionError(f"remote {label}: {res['lost_trajectories']} trajectories "
                                     "lost")
            if (res["same_version_tokens"] == 0
                    or not res["same_version_logp_gap_mean"] <= LOGP_MEAN_TOL):
                raise AssertionError(f"remote {label}: trainer logprobs disagree with the "
                                     "server's")
            if res["reward_timeouts"] or res["reward_failures"]:
                raise AssertionError(f"remote {label}: {res['reward_timeouts']} reward "
                                     f"timeouts, {res['reward_failures']} failures")
            if not all(np.isfinite(res["loss_trajectory"])):
                raise AssertionError(f"remote {label}: a non-finite loss")
            if res["server_version"] != actor.get_version():
                raise AssertionError(f"remote {label}: the server serves version "
                                     f"{res['server_version']}, the trainer is at "
                                     f"{actor.get_version()}")
        if flash_counts_tc() != flash_counts():
            raise AssertionError("a bf16 flash launch of the remote phase missed its "
                                 "tensor-core kernel")
        trainer_peak = torch.cuda.max_memory_allocated()
        server_peak = bench.server_metrics(addr).get("max_memory_allocated", 0)
        print(f"  peak memory: trainer process {trainer_peak / 2**30:.2f} GiB, server process "
              f"{server_peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
        # the served weights after the last (aborting) transfer publish
        t0 = time.perf_counter()
        served = greedy_streams(lambda b: post_addr(addr, "/generate", b), cfg.vocab_size)
        local = GenEngine(cfg.replace(dtype="bfloat16"), params=actor.export_device_params(),
                          n_slots=GRPO_SLOTS, max_seq_len=GRPO_SEQ, prompt_bucket=128,
                          kv_dtype="bfloat16", seed=0)

        def local_generate(body):
            sp = body["sampling_params"]
            req = GenRequest(rid=body["rid"], input_ids=body["input_ids"],
                             max_new_tokens=sp["max_new_tokens"],
                             min_new_tokens=sp["min_new_tokens"], temperature=0.0)
            local.generate_blocking([req])
            return {"output_tokens": req.output_tokens, "output_logprobs": req.output_logprobs}

        mine = greedy_streams(local_generate, cfg.vocab_size)
        del local
        if served != mine:
            raise AssertionError("greedy streams or logprobs of the server process differ "
                                 "from a GenEngine on the trainer's bf16 export")
        print(f"  after the last publish (version {actor.get_version()}): "
              f"{REMOTE_EQUAL_PROMPTS} greedy streams x {REMOTE_EQUAL_TOKENS} tokens and their "
              f"logprobs from the server process equal a GenEngine on the trainer's bf16 "
              f"export here, bit for bit ({time.perf_counter() - t0:.1f} s)")
    finally:
        launcher.stop_all()
        shutdown_reward_pool()
    actor.destroy()
    del actor
    torch.cuda.empty_cache()
    return int(launches[0]), tuple(int(x) for x in launches[1:])


def post_addr(addr, path, body, timeout=600):
    host, _, port = addr.rpartition(":")
    return post(int(port), path, body, timeout)


# ---------------------------------------------------------------------------
# the router phase: two servers behind the port's router, one trainer
# ---------------------------------------------------------------------------

ROUTER_EXP, ROUTER_TRIAL = "chip-smoke-router", "t0"
ROUTER_ALLOC = "jax:d2+d1"  # the gen part's dp 2: two servers
# the router's --train-batch-size, in episodes as the gate leases them (one
# per prompt; a step consumes TRAIN_PROMPTS), and --max-head-offpolicyness
ROUTER_BS, ROUTER_ETA = TRAIN_PROMPTS, 1
# the health checker: probe interval (s), failure threshold, probe timeout (s)
ROUTER_PROBE, ROUTER_THRESHOLD, ROUTER_PROBE_TIMEOUT = 1.0, 3, 2.0
ROUTER_NEW_TOKENS = 128  # per trajectory (the remote phase's 256, halved for time)
ROUTER_FAILOVERS = 5  # the client's failover_retries: above the breaker's threshold
ROUTER_NAMES = ("areal_router_weight_version", "areal_router_rollout_running",
                "areal_router_rollout_accepted_total", "areal_router_admission_capacity",
                "areal_router_flushes_total", "areal_router_requests_routed_total",
                "areal_router_requests_inflight", "areal_router_tokens_inflight",
                "areal_router_failovers_total", "areal_router_handoffs_total",
                "areal_router_handoff_fallbacks_total", "areal_router_backend_state")


def get_addr(addr, path, timeout=60):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_for(cond, what, timeout=120.0, step=0.1):
    """Poll `cond()` until it holds; the seconds it took."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"router phase: {what} within {timeout:.0f} s")
        time.sleep(step)
    return time.perf_counter() - t0


class RouterMonitor:
    """Polls the router's /metrics on a thread: every snapshot's admissions
    against the gate's formula, the time of each backend state change, and
    the router process's resident set (its peak, sampled)."""

    def __init__(self, addr, pid):
        self.addr = addr
        self.pid = pid
        self.peak_rss = None
        self.admissions_over = []  # (accepted + running, allowed) over the formula
        self.max_admitted = 0
        self.polls = 0
        self.changes = []  # (time.perf_counter(), backend, state)
        self._states = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            try:
                m = get_addr(self.addr, "/metrics", timeout=10)
            except OSError:
                continue
            now = time.perf_counter()
            self.polls += 1
            rss = resident_bytes(self.pid)
            if rss is not None:
                self.peak_rss = max(self.peak_rss or 0, rss)
            admitted = m["accepted"] + m["running"]
            allowed = (ROUTER_ETA + m["version"] + 1) * ROUTER_BS
            self.max_admitted = max(self.max_admitted, admitted)
            if admitted > allowed or m["capacity"] < 0:
                self.admissions_over.append((admitted, allowed))
            for a, st in m["backend_states"].items():
                if self._states.get(a) != st["state"]:
                    self._states[a] = st["state"]
                    self.changes.append((now, a, st["state"]))

    def first(self, addr, state, after):
        return next((t for t, a, s in self.changes if a == addr and s == state and t >= after),
                    None)

    def stop(self):
        self._stop.set()
        self._thread.join(10)


def arrivals(log_path, before=None):
    """rid -> server arrival times of /generate in a server's log."""
    out = []
    with open(log_path, errors="replace") as f:
        for line in f:
            m = ARRIVAL_LINE.search(line)
            if m and m.group(1) == "/generate":
                t = float(m.group(2))
                if before is None or t < before:
                    out.append(json.loads(m.group(3))["rid"])
    return out


def resident_bytes(pid):
    """A process's resident set now, from /proc/<pid>/statm (None when
    unreadable)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def router_qwen(ckpt_dir, build_dir):
    """Two port servers behind the port's router at full width (the grpo
    phase's checkpoint of REMOTE_LAYERS layers), the PPO actor here,
    every process found through name_resolve on NFS under `build_dir`.  One
    sync step with a disk publish (the router's watcher flushes both
    servers), two async steps with transfer publishes (the trainer finds
    the servers in name_resolve and tells the router), one more sync step
    with a disk publish, then a rollout during which server 1 is killed:
    it finishes on server 0, server 1 restarts at version 0 and rejoins
    through the router's forced reload.  Returns (K2 launches over the
    servers, the trainer's flash launches)."""
    from areal_tpu_torch.api.config import (
        GenerationHyperparameters,
        GenServerConfig,
        InferenceEngineConfig,
    )
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.core.remote import FleetStalenessGate
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.launcher.local import (
        LocalLauncher,
        build_server_cmd,
        servers_for_allocation,
    )
    from areal_tpu_torch.scripts import bench_e2e_grpo as bench
    from areal_tpu_torch.utils import name_resolve, names
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader
    from areal_tpu_torch.utils.telemetry import parse_prometheus_text
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    nr_root = os.path.join(build_dir, "router_nr")
    meta_disk = WeightUpdateMeta.from_disk(ROUTER_EXP, ROUTER_TRIAL, build_dir, name="router")
    publish_dir = meta_disk.path  # the router's --weights-path
    publish_root = os.path.join(build_dir, "checkpoints", ROUTER_EXP)
    log_dir = os.path.join(build_dir, "router_logs")
    for d in (nr_root, publish_root, log_dir):
        shutil.rmtree(d, ignore_errors=True)
    spec = f"nfs:{nr_root}"
    env_before = {k: os.environ.get(k) for k in ("AREAL_NAME_RESOLVE", "AREAL_LLM_SERVER_ADDRS")}
    os.environ["AREAL_NAME_RESOLVE"] = spec
    saved_store = name_resolve.DEFAULT_REPOSITORY
    name_resolve.reconfigure_from_env()
    launcher = LocalLauncher(log_dir)
    extra = []  # processes started here: the router, the restarted server 1
    clients = []
    monitor = None
    actor = None
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        server_cfg = GenServerConfig(model_path=ckpt_dir, dtype="bfloat16", max_seqs=GRPO_SLOTS,
                                     max_context_len=GRPO_SEQ, page_size=128, random_seed=0)
        n_servers = servers_for_allocation(ROUTER_ALLOC)
        addrs = launcher.start_gen_servers(server_cfg, n_servers, experiment_name=ROUTER_EXP,
                                           trial_name=ROUTER_TRIAL)
        # the trainer's transfer publish finds the servers in name_resolve
        os.environ.pop("AREAL_LLM_SERVER_ADDRS", None)
        registered = sorted(name_resolve.get_subtree(names.gen_servers(ROUTER_EXP,
                                                                       ROUTER_TRIAL)))
        if n_servers != 2 or registered != sorted(addrs):
            raise AssertionError(f"router phase: {n_servers} servers, registered {registered}, "
                                 f"started {addrs}")
        with open(os.path.join(log_dir, "router.log"), "ab") as log_f:
            extra.append(subprocess.Popen(
                [sys.executable, "-m", "areal_tpu_torch.gen.router",
                 f"--experiment-name={ROUTER_EXP}", f"--trial-name={ROUTER_TRIAL}",
                 "--host=127.0.0.1", f"--train-batch-size={ROUTER_BS}",
                 f"--max-head-offpolicyness={ROUTER_ETA}", f"--weights-path={publish_dir}",
                 "--poll-interval=0.2", f"--health-check-interval={ROUTER_PROBE}",
                 f"--health-failure-threshold={ROUTER_THRESHOLD}",
                 f"--health-probe-timeout={ROUTER_PROBE_TIMEOUT}", "--exit-with-parent"],
                env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, stdout=log_f,
                stderr=subprocess.STDOUT, start_new_session=True))
        router = name_resolve.wait(names.gen_router(ROUTER_EXP, ROUTER_TRIAL), timeout=120)
        print(f"  two servers ({ROUTER_ALLOC}) at {addrs} and the router at {router}, found "
              f"through name_resolve ({spec}), in {time.perf_counter() - t0:.1f} s")
        monitor = RouterMonitor(router, extra[0].pid)
        t0 = time.perf_counter()
        actor, cfg = bench._make_actor("qwen2.5-1.5b", GRPO_SEQ, GROUP, model_path=ckpt_dir)
        L = cfg.num_layers
        prewarm_reward_pool()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s")
        workflow = RLVRWorkflow(
            reward_fn=bench._reward_last_even, gconfig=GenerationHyperparameters(
                n_samples=GROUP, max_new_tokens=ROUTER_NEW_TOKENS, temperature=1.0))
        dataset = bench.make_dataset(256, cfg.vocab_size, GRPO_PROMPT_LEN[1],
                                     GRPO_PROMPT_LEN[0], seed=3)

        def client(max_staleness):
            # one batch in flight beyond the one being consumed: with
            # ROUTER_ETA 1 that takes each version's whole fleet budget, and
            # more would leave the next sync step none at its version
            c = RemoteTorchEngine(InferenceEngineConfig(
                experiment_name=ROUTER_EXP, trial_name=ROUTER_TRIAL,
                consumer_batch_size=TRAIN_PROMPTS, max_concurrent_rollouts=TRAIN_PROMPTS,
                max_head_offpolicyness=max_staleness, failover_retries=ROUTER_FAILOVERS))
            c.initialize(addr=router)  # generation goes through the router
            if c.executor.fleet_gate is None or c.executor.fleet_gate.router_addr != router:
                raise AssertionError("router phase: the client did not find the router's gate")
            clients.append(c)
            return c

        sync_client = client(0)
        data_iter = iter(np.random.default_rng(1).permutation(len(dataset)))

        def items():
            return [dataset[int(next(data_iter))] for _ in range(TRAIN_PROMPTS)]

        def fleet_versions():
            return [get_addr(a, "/health")["version"] for a in addrs + [router]]

        def at_version(v):
            return wait_for(lambda: fleet_versions() == [v] * 3,
                            f"servers and router at version {v}", timeout=60, step=0.05)

        flush_s = []
        gaps = [0.0, 0]  # |trainer - server| logprob sum and count, same-version tokens
        per_mode = {"sync": [0, 0.0], "async": [0, 0.0]}
        launches = np.zeros(3, np.int64)
        reset_flash_counts()

        def step(mode, get_batch, publish):
            t_step = time.perf_counter()
            before = np.array(flash_counts())
            t1 = time.perf_counter()
            batch = get_batch()
            t2 = time.perf_counter()
            _, newest = bench._version_lag(batch, actor.get_version())
            if newest > 0:
                raise AssertionError("router phase: a token from a version above the trainer's")
            stats, (gap, n_gap) = bench._train_consume(actor, batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            got = np.array(flash_counts()) - before
            if tuple(got) != (3 * L, L, L):
                raise AssertionError(f"router phase: flash launches {tuple(got)} in a step, not "
                                     f"{(3 * L, L, L)}")
            if not all(np.isfinite([float(s["loss"]) for s in stats])):
                raise AssertionError("router phase: a non-finite loss")
            gaps[0] += gap
            gaps[1] += n_gap
            version = actor.get_version() + 1
            actor.set_version(version)
            t4 = time.perf_counter()
            how = publish(version)
            t5 = time.perf_counter()
            n = int(np.asarray(batch["attention_mask"]).shape[0])
            per_mode[mode][0] += n
            per_mode[mode][1] += t5 - t_step
            launches[:] += got
            print(f"  {mode} step -> version {version}: {n} trajectories, rollout "
                  f"{t2 - t1:.2f} s, train {t3 - t2:.2f} s, publish {how} {t5 - t4:.2f} s "
                  f"(to the fleet and the router at version {version}); |trainer - server| "
                  f"logprob {gap / max(n_gap, 1):.4f} over {n_gap} same-version tokens; "
                  f"reward mean {float(np.asarray(batch['rewards']).mean()):.3f}")

        def disk_publish(version):
            # the trainer writes the snapshot and the name_resolve key; the
            # router's watcher, not the trainer, flushes the servers
            actor.update_weights(meta_disk)
            at_version(version)
            flush_s.append(get_addr(router, "/metrics")["last_flush_s"])
            sync_client.set_version(version)
            return f"disk (watcher flush {flush_s[-1] * 1e3:.1f} ms pause to resume)"

        step("sync", lambda: sync_client.rollout_batch(items(), workflow=workflow), disk_publish)

        # async: a client of its own (two clients of one fleet share the gate)
        async_client = client(4)
        origin = actor.get_version()
        loader = StatefulDataLoader(dataset, batch_size=TRAIN_PROMPTS, seed=0)

        def transfer_publish(version):
            actor.update_weights(WeightUpdateMeta.from_transfer(ROUTER_EXP, ROUTER_TRIAL,
                                                                live_commit=True))
            at_version(version)  # the router by /set_version
            async_client.set_version(version - origin)
            sync_client.set_version(version)
            return "transfer (live commit, /set_version to the router)"

        for _ in range(2):
            step("async", lambda: async_client.prepare_batch(loader, workflow=workflow),
                 transfer_publish)
        # the async client's rollouts still in flight finish before the fault
        wait_for(lambda: async_client.executor.staleness_manager.get_stats().running == 0,
                 "the async client's rollouts to finish", timeout=120)
        step("sync", lambda: sync_client.rollout_batch(items(), workflow=workflow), disk_publish)
        trainer_flash = tuple(int(x) for x in launches)
        if gaps[1] == 0 or not gaps[0] / gaps[1] <= LOGP_MEAN_TOL:
            raise AssertionError("router phase: trainer logprobs disagree with the servers'")
        print(f"  |trainer - server| logprob on same-version tokens over the 4 steps: mean "
              f"{gaps[0] / gaps[1]:.4f} over {gaps[1]} tokens (tolerance {LOGP_MEAN_TOL})")
        if flash_counts_tc() != flash_counts():
            raise AssertionError("a bf16 flash launch of the router phase missed its "
                                 "tensor-core kernel")

        # both servers idle: their K2 launches and prefix accounting so far
        pre = [get_addr(a, "/metrics") for a in addrs]
        for a, m in zip(addrs, pre):
            if m["ragged_kernel_launches"] != L * m["decode_steps"] or m["decode_steps"] == 0:
                raise AssertionError(f"router phase: {a} K2 launches "
                                     f"{m['ragged_kernel_launches']} != {L} x "
                                     f"{m['decode_steps']} decode steps")
            if m["shared_tokens"] <= 0:
                raise AssertionError(f"router phase: no group shared its prefix on {a}")
        routed = get_addr(router, "/metrics")["requests_routed"]
        if sorted(routed) != sorted(addrs) or min(routed.values()) <= 0:
            raise AssertionError(f"router phase: requests_routed {routed}")
        t_fault = time.time()
        placed = {}
        for i in range(n_servers):
            for rid in arrivals(os.path.join(log_dir, f"gen_server_{i}.log"), before=t_fault):
                placed.setdefault(rid.rsplit("-", 1)[0], set()).add(i)
        split = sum(len(s) > 1 for s in placed.values())
        if split or len(placed) < 4 * TRAIN_PROMPTS:
            raise AssertionError(f"router phase: {split} of {len(placed)} groups were split "
                                 "across servers")
        print(f"  before the fault: requests_routed {routed}; {len(placed)} groups, each on "
              f"one server; " + "; ".join(
                  f"{a}: K2 {m['ragged_kernel_launches']} = {L} x {m['decode_steps']} decode "
                  f"steps, prefill cold {m['prefill_tokens']} shared {m['shared_tokens']} "
                  f"suffix {m['suffix_tokens']} reused {m['reused_tokens']}"
                  for a, m in zip(addrs, pre)))

        # the gate at its bound: a probe client takes every admission left
        # at this version, is answered 409 for one more and polls through
        # the 409s until it returns a lease; the fault rollout then gets
        # the admissions back
        m_gate = get_addr(router, "/metrics")
        cap0 = m_gate["capacity"]
        if cap0 != (ROUTER_ETA + m_gate["version"] + 1) * ROUTER_BS - m_gate["accepted"] or (
                cap0 < TRAIN_PROMPTS or m_gate["running"]):
            raise AssertionError(f"router phase: the gate has {cap0} admissions left at version "
                                 f"{m_gate['version']} with {m_gate['accepted']} accepted and "
                                 f"{m_gate['running']} running, the next rollout needs "
                                 f"{TRAIN_PROMPTS}")
        probe_pool = concurrent.futures.ThreadPoolExecutor(2)
        probe = FleetStalenessGate(router, probe_pool, poll_interval=0.05)
        leases = [asyncio.run(probe.allocate("probe")) for _ in range(cap0)]

        async def poll_through():
            task = asyncio.ensure_future(probe.allocate("probe"))
            t_wait = time.perf_counter()
            while probe.n_staled < 3 and not task.done():
                if time.perf_counter() - t_wait > 30:
                    break
                await asyncio.sleep(0.01)
            if task.done():
                raise AssertionError("router phase: the gate granted an admission over its "
                                     "formula")
            await probe.finish(leases.pop(), accepted=False)
            return await asyncio.wait_for(task, 30)

        try:
            if None in leases or probe.n_staled:
                raise AssertionError(f"router phase: the gate refused one of the {cap0} "
                                     "admissions it had left")
            leases.append(asyncio.run(poll_through()))
            probe_staled = probe.n_staled
            if leases[-1] is None or probe_staled < 3:
                raise AssertionError(f"router phase: the probe got {probe_staled} answers 409 "
                                     "and no lease")
        finally:
            for lease in leases:
                asyncio.run(probe.finish(lease, accepted=False))
            probe_pool.shutdown()
        m_after = get_addr(router, "/metrics")
        if (m_after["capacity"], m_after["accepted"], m_after["running"]) != (
                cap0, m_gate["accepted"], 0):
            raise AssertionError(f"router phase: the gate did not take the probe's leases back: "
                                 f"{m_after['capacity']} left, {m_after['accepted']} accepted, "
                                 f"{m_after['running']} running")
        print(f"  gate probe at version {m_gate['version']}: {cap0} admissions left = (1 + "
              f"{m_gate['version']} + 1) x {ROUTER_BS} - {m_gate['accepted']} accepted; the "
              f"probe took them all, was answered 409 {probe_staled} times for one more and got "
              f"it once a lease came back; all returned unaccepted")

        # the fault: server 1 killed partway through a rollout
        fault_box = {}
        lost0 = sync_client.executor.lost_trajectories

        def fault_rollout():
            try:
                fault_box["batch"] = sync_client.rollout_batch(items(), workflow=workflow)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                fault_box["error"] = e

        rollout_thread = threading.Thread(target=fault_rollout, daemon=True)
        t_roll = time.perf_counter()
        rollout_thread.start()
        victim = launcher.procs[1]
        last1 = {}  # server 1's last /metrics before the kill

        def server1_decoding():
            last1.update(get_addr(addrs[1], "/metrics"))
            return last1["decode_steps"] > pre[1]["decode_steps"] + 16

        wait_for(server1_decoding, "server 1 decoding the rollout", timeout=60, step=0.02)
        os.killpg(victim.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        victim.wait()
        rollout_thread.join(300)
        if rollout_thread.is_alive() or "error" in fault_box:
            raise AssertionError(f"router phase: the rollout did not finish on server 0: "
                                 f"{fault_box.get('error')!r}")
        t_done = time.perf_counter()
        bound = ROUTER_THRESHOLD * ROUTER_PROBE + ROUTER_PROBE_TIMEOUT + 2.0
        wait_for(lambda: monitor.first(addrs[1], "open", t_kill) is not None,
                 "the breaker open", timeout=bound + 10, step=0.05)
        t_open = monitor.first(addrs[1], "open", t_kill)
        if t_open - t_kill > bound:
            raise AssertionError(f"router phase: the breaker did not open within {bound} s")
        m_fault = get_addr(router, "/metrics")
        if m_fault["failovers"] < 1:
            raise AssertionError("router phase: no failover counted")
        lost = sync_client.executor.lost_trajectories - lost0
        n_fault = int(np.asarray(fault_box["batch"]["attention_mask"]).shape[0])
        if lost or n_fault != TRAIN_PROMPTS * GROUP:
            raise AssertionError(f"router phase: {lost} trajectories lost in the fault rollout")
        print(f"  SIGKILL of server 1 {t_kill - t_roll:.2f} s into a rollout: breaker open "
              f"{t_open - t_kill:.3f} s after the kill (bound {bound:.1f} s), the rollout "
              f"finished on server 0 {t_done - t_kill:.2f} s after it: {n_fault} trajectories, "
              f"none lost; router failovers {m_fault['failovers']}")

        # server 1 back at the same address, from the original checkpoint
        port1 = int(addrs[1].rpartition(":")[2])
        with open(os.path.join(log_dir, "gen_server_1_restart.log"), "ab") as log_f:
            extra.append(subprocess.Popen(
                build_server_cmd(server_cfg, port1, None, ROUTER_EXP, ROUTER_TRIAL, 1),
                env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, stdout=log_f,
                stderr=subprocess.STDOUT, start_new_session=True))
        t_restart = time.perf_counter()
        wait_for(lambda: monitor.first(addrs[1], "closed", t_restart) is not None,
                 "server 1 closed again after its restart", timeout=180, step=0.1)
        t_half = monitor.first(addrs[1], "half_open", t_restart)
        t_closed = monitor.first(addrs[1], "closed", t_restart)
        version = actor.get_version()
        if fleet_versions() != [version] * 3:
            raise AssertionError(f"router phase: after the rejoin the fleet serves "
                                 f"{fleet_versions()}, the trainer is at {version}")
        print(f"  server 1 restarted at version 0: half-open "
              f"{(t_half or t_closed) - t_restart:.2f} s and closed {t_closed - t_restart:.2f} s "
              f"after the restart, force-reloaded to version {version}")

        # the gate's ledger, balanced once every lease is back
        wait_for(lambda: get_addr(router, "/metrics")["running"] == 0,
                 "every lease returned", timeout=120)
        m_end = get_addr(router, "/metrics")
        local = [c.executor.staleness_manager.get_stats() for c in clients]
        accepted = sum(s.accepted for s in local)
        for c, s in zip(clients, local):
            if s.submitted != s.accepted + s.rejected + s.running or s.running:
                raise AssertionError("router phase: a client's staleness ledger does not "
                                     "balance")
            if c.executor.lost_trajectories:
                raise AssertionError("router phase: a trajectory was lost")
        if m_end["accepted"] != accepted:
            raise AssertionError(f"router phase: the router accepted {m_end['accepted']}, the "
                                 f"clients {accepted}")
        monitor.stop()
        if monitor.admissions_over or monitor.polls == 0:
            raise AssertionError(f"router phase: admissions over the gate's formula "
                                 f"{monitor.admissions_over[:5]}")
        staled = sum(c.executor.fleet_gate.n_staled for c in clients)
        if probe_staled <= 0:
            raise AssertionError("router phase: the gate never answered 409")
        with urllib.request.urlopen(f"http://{router}/metrics?format=prometheus",
                                    timeout=60) as resp:
            prom = parse_prometheus_text(resp.read().decode())
        missing = [n for n in ROUTER_NAMES if n not in prom]
        if missing:
            raise AssertionError(f"router phase: Prometheus lacks {missing}")
        print(f"  gate: {m_end['accepted']} accepted = the clients' {accepted}, 0 running, "
              f"at most {monitor.max_admitted} admitted against (1 + version + 1) x "
              f"{ROUTER_BS} over {monitor.polls} polls; answers 409: {staled} to the trainer's "
              f"clients, {probe_staled} to the probe; flushes "
              f"{m_end['n_flushes']}, publish partial failures "
              f"{m_end['publish_partial_failures']}; Prometheus renders all "
              f"{len(ROUTER_NAMES)} areal_router_* names")
        for mode, (n, wall) in per_mode.items():
            print(f"  {mode}: {n / wall:.4f} trajectories/s/chip through the router "
                  f"({n} trajectories, {wall:.2f} s with training and publishes)")
        print("  fleet flush, pause to resume over two servers: "
              + ", ".join(f"{x * 1e3:.1f}" for x in flush_s) + " ms")

        # the served weights after the last (disk) publish, rejoined server included
        t0 = time.perf_counter()
        served = [greedy_streams(lambda b, a=a: post_addr(a, "/generate", b), cfg.vocab_size)
                  for a in addrs]
        local_eng = GenEngine(cfg.replace(dtype="bfloat16"),
                              params=actor.export_device_params(), n_slots=GRPO_SLOTS,
                              max_seq_len=GRPO_SEQ, prompt_bucket=128, kv_dtype="bfloat16",
                              seed=0)

        def local_generate(body):
            sp = body["sampling_params"]
            req = GenRequest(rid=body["rid"], input_ids=body["input_ids"],
                             max_new_tokens=sp["max_new_tokens"],
                             min_new_tokens=sp["min_new_tokens"], temperature=0.0)
            local_eng.generate_blocking([req])
            return {"output_tokens": req.output_tokens, "output_logprobs": req.output_logprobs}

        mine = greedy_streams(local_generate, cfg.vocab_size)
        del local_eng
        if not served[0] == served[1] == mine:
            raise AssertionError("router phase: greedy streams or logprobs of the servers "
                                 "differ from each other or from a GenEngine on the trainer's "
                                 "bf16 export")
        print(f"  after the last publish (version {version}): {REMOTE_EQUAL_PROMPTS} greedy "
              f"streams x {REMOTE_EQUAL_TOKENS} tokens and their logprobs from each server "
              f"(server 1 rejoined) equal each other and a GenEngine on the trainer's bf16 "
              f"export here, bit for bit ({time.perf_counter() - t0:.1f} s)")

        post = [get_addr(a, "/metrics") for a in addrs]
        for a, m, label in zip(addrs, post, ("server 0", "server 1 (restarted)")):
            if m["ragged_kernel_launches"] != L * m["decode_steps"]:
                raise AssertionError(f"router phase: {label} K2 launches != {L} x decode steps")
        # a read mid-step may fall between a step's launches and its count
        if last1["ragged_kernel_launches"] < pre[1]["ragged_kernel_launches"] + 16 * L:
            raise AssertionError("router phase: server 1's K2 launches did not grow with "
                                 "its decode steps before the kill")
        # server 1's first process: its launches up to its last read, a poll
        # (<= 20 ms) before the kill; those after that read died with it, so
        # the sum is a lower bound
        k2 = post[0]["ragged_kernel_launches"] + last1["ragged_kernel_launches"] + post[1][
            "ragged_kernel_launches"]
        print(f"  K2: at least {k2}: server 0 {post[0]['ragged_kernel_launches']} = {L} x "
              f"{post[0]['decode_steps']} decode steps; server 1 "
              f"{last1['ragged_kernel_launches']} ({last1['decode_steps']} decode steps) at its "
              f"last read before the kill (those after it died with it), restarted "
              f"{post[1]['ragged_kernel_launches']} = {L} x {post[1]['decode_steps']}; trainer "
              f"flash fwd/dq/dkv {trainer_flash} over 4 steps, on the tensor cores")
        print(f"  peak memory: trainer {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"server 0 {post[0].get('max_memory_allocated', 0) / 2**30:.2f} GiB, server 1 "
              f"before the fault {pre[1].get('max_memory_allocated', 0) / 2**30:.2f} GiB, "
              f"restarted {post[1].get('max_memory_allocated', 0) / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); router process: no device memory, "
              + (f"resident at most {monitor.peak_rss / 2**30:.3f} GiB (/proc statm, sampled "
                 f"every 50 ms)" if monitor.peak_rss else "resident set not measured"))
    finally:
        if monitor is not None:
            monitor.stop()
        for c in clients:
            c.destroy()
        for p in extra:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        launcher.stop_all()
        shutdown_reward_pool()
        name_resolve.DEFAULT_REPOSITORY = saved_store
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for d in (nr_root, publish_root):
            shutil.rmtree(d, ignore_errors=True)
    if actor is not None:
        actor.destroy()
    del actor
    torch.cuda.empty_cache()
    return int(k2), trainer_flash


# the recover phase: the example's run, killed after step 1 and relaunched
RECOVER_LAYERS = 4  # depth of the in-process save/load checks (full width)
# depth of the launched run in the whole script.  The card's host takes
# 45 GiB of disk writes per run (deleted files count): the earlier phases write
# about 26 GB, and at 28 layers one recover generation is 18.5 GB (two
# dumps, the checkpoint and the export: 43 GB).  `--only recover-full-depth`
# runs the launched run alone at 28 layers.
RECOVER_RUN_LAYERS = 2
RECOVER_STEPS = 3
RECOVER_KILL = "train_step@2:kill"  # SIGKILL at the end of global step 1
RECOVER_OVERRIDES = [
    # 256 new tokens (the example's default is 512) keep the script under 900 s
    f"total_train_steps={RECOVER_STEPS}", "gconfig.max_new_tokens=256",
    "actor.kl_ctl=0.001", "ref.dtype=bfloat16",
    "valid_dataset.type=gsm8k-synth", "valid_dataset.batch_size=32",
    # FrequencyControl counts from step 0, so freq_steps=1 first fires at
    # step 1; freq_secs=0 fires at every step
    "evaluator.freq_secs=0", "checkpointer.freq_steps=1", "recover.keep_generations=1",
    "saver.freq_steps=2", "recover.mode=fault", "recover.retries=1",
]
ARRIVAL_LINE = re.compile(r"arrival (\S+) at (\S+) (.*)$")  # the server's arrival log


def recover_batch(seed, vocab, B=32):
    """A GRPO-shaped padded batch: prompts of 64..256 random tokens, 64..256
    completion tokens with behaviour logprobs, 0/1 rewards."""
    rng = np.random.default_rng(seed)
    P, N = rng.integers(64, 257, B), rng.integers(64, 257, B)
    L = int((P + N).max())
    pos = np.arange(L)[None, :]
    mask = pos < (P + N)[:, None]
    loss_mask = (mask & (pos >= P[:, None])).astype(np.float32)
    return {"input_ids": (rng.integers(0, vocab, (B, L)) * mask).astype(np.int32),
            "attention_mask": mask, "loss_mask": loss_mask,
            "logprobs": (rng.normal(-2.0, 0.5, (B, L)) * loss_mask).astype(np.float32),
            "rewards": rng.integers(0, 2, B).astype(np.float32)}


def recover_save_load(work_dir):
    """Qwen2.5-1.5B's width at RECOVER_LAYERS layers, the example's actor
    config (f32 masters, bf16 compute, full remat, 2 minibatches of 2
    micro-batches): one update, `save` with the optimizer, `load` into a
    fresh actor (masters, mu/nu and the update count bit-equal), then one
    `ppo_update` on one fixed batch from the loaded and from the live state:
    bit-equal params, every flash launch on the tensor cores, counted.
    Returns the flash launches of those two updates."""
    import copy

    from areal_tpu_torch.api.config import MicroBatchSpec
    from areal_tpu_torch.api.io_struct import SaveLoadMeta

    mc = qwen25_1p5b().replace(num_layers=RECOVER_LAYERS)
    cfg = PPOActorConfig(init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
                         group_size=4, ppo_n_minibatches=2, mb_spec=MicroBatchSpec(n_mbs=2),
                         pack_length_quantum=512, max_pack_length=2048,
                         adv_norm=NormConfig(mean_level="group", std_level="group"),
                         optimizer=OptimizerConfig(lr=1e-6, weight_decay=0.01,
                                                   warmup_steps_proportion=0.001))
    ft = FinetuneSpec(1, 1024, 8)

    def prepared(actor, seed):
        b = recover_batch(seed, mc.vocab_size)
        b["prox_logp"] = actor.compute_logp(b)
        actor.compute_advantages(b)
        return b

    live = TorchPPOActor(cfg, mc, device="cuda")
    live.initialize(ft_spec=ft)
    live.ppo_update(prepared(live, 0))
    torch.cuda.synchronize()
    path = os.path.join(work_dir, "ckpt")
    t0 = time.perf_counter()
    live.save(SaveLoadMeta(path=path, with_optim=True))
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    fresh = TorchPPOActor(cfg, mc, device="cuda")
    fresh.initialize(ft_spec=ft)
    t0 = time.perf_counter()
    fresh.load(SaveLoadMeta(path=path, with_optim=True))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def same_state():
        a, b = live._optimizer, fresh._optimizer
        return (a.count == b.count and a.names == b.names
                and all(torch.equal(p, q) for p, q in zip(a.params, b.params))
                and all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu)))

    if not same_state():
        raise AssertionError("the loaded masters or mu/nu differ from the saved ones")
    batch = prepared(live, 1)
    reset_flash_counts()
    stats_live = live.ppo_update(copy.deepcopy(batch))
    stats_fresh = fresh.ppo_update(copy.deepcopy(batch))
    torch.cuda.synchronize()
    launches, on_tc = flash_counts(), flash_counts_tc()
    n_mb = 2 * cfg.ppo_n_minibatches * cfg.mb_spec.n_mbs
    L = RECOVER_LAYERS
    print(f"  {L} layers at full width: save {save_s:.2f} s ({nbytes / 1e9:.3f} GB, f32 masters "
          f"+ mu/nu), load {load_s:.2f} s; masters, mu/nu and count {live._optimizer.count} "
          f"bit-equal after load; losses live {[s['loss'] for s in stats_live]} / loaded "
          f"{[s['loss'] for s in stats_fresh]}; flash launches fwd/dq/dkv {launches}, on the "
          f"tensor cores {on_tc}")
    if launches != (2 * L * n_mb, L * n_mb, L * n_mb) or on_tc != launches:
        raise AssertionError(f"the two updates launched {launches} flash kernels ({on_tc} on "
                             f"the tensor cores), not {(2 * L * n_mb, L * n_mb, L * n_mb)}")
    if not same_state():
        raise AssertionError("one ppo_update from the loaded state is not bit-equal to the "
                             "update from the live state")
    print("  one ppo_update from the loaded state equals the live one bit for bit "
          "(params, mu/nu)")
    del live, fresh
    torch.cuda.empty_cache()
    return launches


def segment_lengths(seg_rows):
    """The sequence lengths packed into rows of segment ids."""
    rows = np.asarray(seg_rows)
    return [int((row == s).sum()) for row in rows for s in np.unique(row[row >= 0])]


def recover_ref_forward(lens):
    """The example's ref engine (a TorchTrainEngine without optimizer,
    bf16 compute, random weights from seed 0) at full width, 28 layers, on
    random sequences of lengths `lens` (the grpo phase's packed train
    rows'): one forward, K1a launched once per layer on the tensor cores;
    then the same forward through naive attention (`attn_impl` "naive"),
    within LOGP_MEAN_TOL on the mean; then the flash kernels on the
    forward's packed rows, timed against their plain versions and SDPA,
    with bounds (`time_flash`).  Returns the forward's flash launches."""
    from areal_tpu_torch.api.config import TrainEngineConfig
    from areal_tpu_torch.engine.torch_train import TorchTrainEngine

    rng = np.random.default_rng(11)
    mc = qwen25_1p5b()
    Lmax = max(lens)
    mask = np.arange(Lmax)[None, :] < np.asarray(lens)[:, None]
    batch = {"input_ids": (rng.integers(0, mc.vocab_size, (len(lens), Lmax)) * mask
                           ).astype(np.int32), "attention_mask": mask}
    ref = TorchTrainEngine(TrainEngineConfig(init_from_scratch=True, dtype="bfloat16",
                                             optimizer=None), mc, device="cuda")
    ref.initialize()
    ref.forward(batch)  # warm
    torch.cuda.synchronize()
    reset_flash_counts()
    t0 = time.perf_counter()
    got = ref.forward(batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches, on_tc = flash_counts(), flash_counts_tc()
    ref.model.cfg = ref.model_config.replace(attn_impl="naive")
    try:
        plain = ref.forward(batch)
    finally:
        ref.model.cfg = ref.model_config
    if flash_counts() != launches:
        raise AssertionError("the plain forward launched a flash kernel")
    valid = mask[:, 1:]
    gap = np.abs(got[:, :-1] - plain[:, :-1])[valid]
    print(f"  ref forward at 28 layers on {len(lens)} sequences ({int(mask.sum())} tokens): "
          f"{fwd_s:.3f} s; K1a launches {launches[0]} (tensor cores "
          f"{on_tc[0]}); |flash - naive| logprob mean {gap.mean():.5f}, max {gap.max():.4f} "
          f"(tolerance on the mean {LOGP_MEAN_TOL})")
    if launches != (SERVE_LAYERS, 0, 0) or on_tc != launches:
        raise AssertionError(f"the ref forward launched {launches} flash kernels, not one K1a "
                             "per layer on the tensor cores")
    if not np.isfinite(got[:, :-1][valid]).all() or not gap.mean() <= LOGP_MEAN_TOL:
        raise AssertionError("the ref forward disagrees with the plain attention path")
    seg_rows = ref._prepare_rows(batch, 1)[1]["segment_ids"]
    del ref
    torch.cuda.empty_cache()
    print("  the flash kernels on the ref forward's packed rows (K1a is the one it runs):")
    time_flash(seg_rows)
    return launches


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def recover_run(fileroot, layers):
    """`python -m areal_tpu_torch.examples.math.gsm8k_grpo --launch` at full
    width and `layers` layers (an HF checkpoint of random bf16 weights,
    seed 0, which the trainer, the ref engine and the server load) with the
    transfer publish, KL to the ref engine, the evaluator and the
    checkpointer at every step, a bf16 export at the last step, and
    `AREAL_FAULT_POINTS` killing the first trainer at the end of step 1; the
    launcher relaunches it and run 1 resumes.  Checks the run from the files
    it leaves and prints its recover timings.  Returns (K2 launches of the
    server, K1 launches of both trainers)."""
    from areal_tpu_torch.api.config import RecoverConfig
    from areal_tpu_torch.utils.recover import RecoverHandler

    shutil.rmtree(fileroot, ignore_errors=True)
    os.makedirs(fileroot)
    print(f"  free disk under {fileroot}: {shutil.disk_usage(fileroot).free / 1e9:.1f} GB")
    ckpt = os.path.join(fileroot, "ckpt")
    write_checkpoint(qwen25_1p5b().replace(num_layers=layers).to_hf_dict(), ckpt)
    cmd = [sys.executable, "-m", "areal_tpu_torch.examples.math.gsm8k_grpo", "--launch",
           "--relaunch-delay", "1", "--trainer-timeout", "600", "--weight-update-mode",
           "transfer", *RECOVER_OVERRIDES, f"actor.path={ckpt}", "actor.init_from_scratch=false",
           f"cluster.fileroot={fileroot}"]
    env = {**os.environ, "PYTHONPATH": ROOT, "AREAL_FAULT_POINTS": RECOVER_KILL}
    for k in ("AREAL_LLM_SERVER_ADDRS", "AREAL_RUN_ID"):
        env.pop(k, None)
    log_path = os.path.join(fileroot, "launch.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    run_dir = os.path.join(fileroot, "gsm8k-grpo", "trial0")
    logs = os.path.join(run_dir, "logs")
    if rc != 0:
        tails = []
        for name in ("launch.log", *sorted(os.listdir(logs) if os.path.isdir(logs) else [])):
            path = os.path.join(fileroot if name == "launch.log" else logs, name)
            with open(path, errors="replace") as f:
                tails.append(f"--- {name}\n" + "".join(f.readlines()[-30:]))
        raise AssertionError(f"the launched run exited {rc}:\n" + "\n".join(tails))
    print(f"  {' '.join(cmd[3:])}\n  at {layers} layers, with AREAL_FAULT_POINTS={RECOVER_KILL}: "
          f"exit 0 after {wall:.1f} s")
    stats = _jsonl(os.path.join(fileroot, "logs", "gsm8k-grpo", "trial0", "stats.jsonl"))
    events = _jsonl(os.path.join(logs, "launcher.jsonl"))
    exits = [(e["run_id"], e["rc"]) for e in events if e["event"] == "trainer_exit"]
    print(f"  trainer exits (run id, rc): {exits}")
    if exits != [(0, -9), (1, 0)]:
        raise AssertionError("run 0 was not killed and relaunched into a run 1 that finished")
    seq = [(s["global_step"], s["run_id"], s["version"]) for s in stats]
    print(f"  StatsLogger (global_step, run_id, version): {seq}")
    if seq != [(0, 0, 1), (1, 0, 2), (2, 1, 3)]:
        raise AssertionError("the steps, run ids or versions do not continue across the kill")
    start1 = next(e["ts"] for e in events if e["event"] == "trainer_start" and e["run_id"] == 1)
    with open(os.path.join(logs, "gen_server_0.log")) as f:
        arrivals = [(float(m[2]), m[1], json.loads(m[3])) for m in map(ARRIVAL_LINE.search, f)
                    if m]
    first = [(p, d) for ts, p, d in arrivals if ts > start1][:3]
    print(f"  run 1's first requests to the server: {first}")
    if first[:2] != [("/update_weights_chunk", {"action": "prepare", "version": 2}),
                     ("/update_weights_chunk", {"action": "commit", "version": 2,
                                                "live": False})] or first[2][0] != "/generate":
        raise AssertionError("run 1's first weight action is not the reload pinned to version 2 "
                             "(an aborting commit) before any generate")
    for s in stats:
        led = (s["ledger/submitted"], s["ledger/accepted"], s["ledger/rejected"],
               s["ledger/running"])
        if led[0] != led[1] + led[2] + led[3]:
            raise AssertionError(f"step {s['global_step']}: the ledger {led} does not balance")
        if not np.isfinite(s["ppo_actor/loss"]) or not s["kl_ref"] or "eval_reward_mean" not in s:
            raise AssertionError(f"step {s['global_step']}: a non-finite loss, a zero KL "
                                 "statistic or no eval reward")
    resumed = stats[2]
    ledgers = [tuple(s[f"ledger/{k}"] for k in ("submitted", "accepted", "rejected", "running"))
               for s in stats]
    print(f"  ledgers {ledgers}; "
          f"run 1 settled {resumed['recover/settled_inflight']} in-flight trajectories, lost "
          f"{resumed['lost_trajectories']}")
    if resumed["lost_trajectories"] != resumed["recover/settled_inflight"] or any(
            s["lost_trajectories"] for s in stats[:2]):
        raise AssertionError("lost_trajectories is not the settled count")
    # load() takes the newest generation whose every digest checks out
    if resumed["recover/recovered_step"] != 1 or not resumed["recover/validate_s"] > 0:
        raise AssertionError("run 1 did not load the step-1 generation (its digests failed?)")
    gens = RecoverHandler(RecoverConfig(experiment_name="gsm8k-grpo", trial_name="trial0",
                                        fileroot=fileroot)).generations()
    print(f"  run 1 loaded the step-1 generation, its digests checked; generations left "
          f"{[os.path.basename(g) for g in gens]}")
    for s in stats:
        if "recover/dump_s" in s:
            print(f"  dump at step {s['global_step']}: {s['recover/dump_s']:.2f} s for "
                  f"{s['recover/dump_gb']:.3f} GB (write {s['recover/write_s']:.2f} s, blake2b "
                  f"digests {s['recover/digest_s']:.2f} s, fsync {s['recover/fsync_s']:.2f} s)")
    kill_ts = next(e["ts"] for e in events if e["event"] == "trainer_exit" and e["run_id"] == 0)
    print(f"  load in run 1: {resumed['recover/load_s']:.2f} s (validate "
          f"{resumed['recover/validate_s']:.2f} s, restore {resumed['recover/restore_s']:.2f} s, "
          f"pinned transfer replay {resumed['recover/replay_s']:.2f} s); kill -> run 1's first "
          f"trained step {resumed['ts'] - kill_ts:.1f} s (relaunch at +{start1 - kill_ts:.1f} s, "
          f"the step itself {resumed['step_s']:.1f} s)")
    for s in stats:
        print(f"  step {s['global_step']} (run {s['run_id']}): {s['step_s']:.2f} s, rollout "
              f"{s['timing/rollout']:.2f} s, ref forward {s['timing/ref_logp']:.3f} s, eval "
              f"{s['timing/eval']:.2f} s (reward {s['eval_reward_mean']:.3f} on "
              f"{s['eval_n']}), loss {s['ppo_actor/loss']:+.5f}, kl_ref {s['kl_ref']:.5f}")
    for run in (0, 1):
        mine = [s for s in stats if s["run_id"] == run]
        rate = sum(s["n_seqs"] for s in mine) / sum(s["step_s"] for s in mine)
        print(f"  run {run}: {rate:.4f} trajectories/s/chip over {len(mine)} steps")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    flash = np.zeros(3, np.int64)
    for run, n_steps in ((0, 2), (1, 1)):
        last = [s for s in stats if s["run_id"] == run][-1]
        got = np.array([last[f"launches/{n}"] for n in names])
        tc = np.array([last[f"launches/{n}_tc"] for n in names])
        L = layers
        want = np.array([(2 + 2 * 4) * L, 4 * L, 4 * L]) * n_steps
        if not (got == tc).all() or not (got == want).all():
            raise AssertionError(f"run {run}: flash launches {got} (tensor cores {tc}), not "
                                 f"{want}: a logprob, ref or update pass missed a kernel")
        flash += got
    metrics = next(e["metrics"] for e in events if e["event"] == "server_metrics")
    ragged = metrics["ragged_kernel_launches"]
    print(f"  launches: flash fwd/dq/dkv {tuple(int(x) for x in flash)} in the trainers; ragged "
          f"{ragged} = {layers} x {metrics['decode_steps']} decode steps in the server")
    if ragged != layers * metrics["decode_steps"] or ragged == 0:
        raise AssertionError(f"the server's ragged launches are not {layers} x its decode steps")
    return ragged, tuple(int(x) for x in flash)


def recover_phase(build_dir, lens):
    """The recover phase's three parts; returns (K2 launches, K1 launches
    of the phase's paths: the launched run's trainers, the in-process
    updates and the ref forward)."""
    work = os.path.join(build_dir, "recover_inproc")
    shutil.rmtree(work, ignore_errors=True)
    try:
        bit_equal = recover_save_load(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ref = recover_ref_forward(lens)
    fileroot = os.path.join(build_dir, "recover_run")
    try:
        ragged, flash = recover_run(fileroot, RECOVER_RUN_LAYERS)
    finally:
        shutil.rmtree(fileroot, ignore_errors=True)
    return ragged, tuple(a + b + c for a, b, c in zip(flash, bit_equal, ref))


# ---------------------------------------------------------------------------
# the dense families at full width
# ---------------------------------------------------------------------------

# google/gemma-2-2b config.json: the keys the port reads
GEMMA2_2B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 2304, "intermediate_size": 9216,
    "num_hidden_layers": 26, "num_attention_heads": 8, "num_key_value_heads": 4,
    "head_dim": 256, "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "query_pre_attn_scalar": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "attention_bias": False, "tie_word_embeddings": True,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
}
# Qwen/Qwen3-1.7B config.json: the keys the port reads
QWEN3_1P7B = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 128, "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": True, "use_sliding_window": False, "sliding_window": None,
    "bos_token_id": 151643, "eos_token_id": 151645,
}
FAMILY_SLOTS, FAMILY_SEQ = 8, 8192
# Gemma-2-2B's 26 layers cut to 10 (5 of them windowed): the windows must
# still move the long request's logprobs by more than LOGP_MEAN_TOL (a
# mean 0.0947 at 26 layers, 0.2464 at 18 and 0.3080 at 10 on an H100)
GEMMA2_LAYERS = 10
LONG_PROMPT = 4500  # past Gemma-2's window of 4096
SHORT_PROMPTS = (300, 700, 1200)  # the long request's three companions
FAMILY_NEW = 64  # new tokens per request of the Gemma-2 server
FAMILY_PROMPT_LEN = (128, 512)  # the Gemma-2 rollouts' prompts
# the Qwen3 loop: sync and async with a live publish, 1 warmup + 1 timed each
FAMILY_PLANS = GRPO_PLANS[:2]


def write_checkpoint(hf_config, out_dir):
    """Random bf16 weights (seed 0) of an HF config, written as an HF
    checkpoint by the port's writer; returns the config."""
    cfg = TransformerConfig.from_hf(hf_config)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    n = sum(p.numel() for p in model.parameters())
    save_hf_checkpoint(model, out_dir)
    del model
    torch.cuda.empty_cache()
    print(f"  {cfg.hf_architecture}: {n / 1e9:.3f} B parameters, {cfg.num_layers} layers, "
          f"written as an HF checkpoint in {time.perf_counter() - t0:.1f} s")
    return cfg


def packed_logprobs(model, ids, window=True):
    """Next-token logprobs [T - 1] of one sequence through the port's
    packed forward (`forward_lm`: naive attention with the per-layer window
    masks, the softcapped chunked head); `window=False` runs the same
    weights with every window taken away."""
    from areal_tpu_torch.models.transformer import forward_lm
    from areal_tpu_torch.ops.functional import lm_logprobs_entropy

    t = torch.tensor(ids, device="cuda")[None]
    pos = torch.arange(t.shape[1], device="cuda")[None]
    cfg = model.cfg
    if not window:
        model.cfg = cfg.replace(sliding_window=None, layer_is_sliding=None)
    try:
        with torch.no_grad():
            out = forward_lm(model, t, pos, torch.zeros_like(pos))
            lp, _, _ = lm_logprobs_entropy(out, torch.roll(t, -1, dims=-1), with_entropy=False)
    finally:
        model.cfg = cfg
    return lp[0, :-1].float().cpu().numpy()


def gemma_serve_and_train(ckpt_dir, publish_dir):
    """Gemma-2-2B at full width (GEMMA2_LAYERS of its 26 layers), random
    weights from seed 0,
    through `areal_tpu_torch.gen.server.main` (8 slots, max_seq_len 8192):
    a greedy request with a prompt past the window and three shorter ones
    (64 new tokens each); the long request's served logprobs against the
    packed forward with the per-layer windows, which must differ from the
    same forward without them; 8 prompts x group 4 rolled out over HTTP,
    the PPO actor's logprob recompute and 2 updates (f32 masters, bf16
    compute, full remat, naive attention under the per-layer windows as in
    JAX, the softcapped chunked head); a disk publish the server reloads.
    Then decode tokens/s on the engine.  Returns the K2 launches (the
    server's /metrics) and the train stats."""
    cfg = write_checkpoint(dict(GEMMA2_2B, num_hidden_layers=GEMMA2_LAYERS), ckpt_dir)
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots",
                         str(FAMILY_SLOTS), "--max-seq-len", str(FAMILY_SEQ)]) as httpd:
        port, engine = httpd.port, httpd.gen.engine
        print(f"  server up in {time.perf_counter() - t0:.1f} s "
              f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
        greedy = dict(max_new_tokens=FAMILY_NEW, min_new_tokens=FAMILY_NEW, temperature=0.0)
        long_ids = rng.integers(0, V, LONG_PROMPT).tolist()
        shorts = [dict(rid=f"s{i}", input_ids=rng.integers(0, V, n).tolist(),
                       sampling_params=greedy) for i, n in enumerate(SHORT_PROMPTS)]
        m0 = get(port, "/metrics")
        t0 = time.perf_counter()
        # alone: a 4500-token prompt prefills in the 8192 bucket
        long = post(port, "/generate", dict(rid="long", input_ids=long_ids,
                                            sampling_params=greedy))
        with concurrent.futures.ThreadPoolExecutor(len(shorts)) as pool:
            results = [long] + list(pool.map(lambda b: post(port, "/generate", b), shorts))
        wall = time.perf_counter() - t0
        m1 = get(port, "/metrics")
        launches = m1["ragged_kernel_launches"] - m0["ragged_kernel_launches"]
        steps = m1["decode_steps"] - m0["decode_steps"]
        print(f"  {len(results)} greedy requests (prompts of {LONG_PROMPT}, "
              f"{', '.join(map(str, SHORT_PROMPTS))} tokens) x {FAMILY_NEW} tokens in "
              f"{wall:.2f} s; ragged {launches} = {L} x {steps} decode steps (/metrics)")
        for r in results:
            lp = np.asarray(r["output_logprobs"])
            if len(r["output_tokens"]) != FAMILY_NEW or not (np.isfinite(lp).all()
                                                             and (lp <= 0).all()):
                raise AssertionError(f"a Gemma-2 request did not return {FAMILY_NEW} "
                                     "finite logprobs")
        if steps == 0 or launches != L * steps:
            raise AssertionError(f"Gemma-2 decode did not run its {L} layers through K2")

        t0 = time.perf_counter()
        ids = long_ids + long["output_tokens"]
        P = len(long_ids)
        served = np.asarray(long["output_logprobs"])
        windowed = packed_logprobs(engine.model, ids)[P - 1:]
        unwindowed = packed_logprobs(engine.model, ids, window=False)[P - 1:]
        gap = np.abs(windowed - served)
        lost = np.abs(unwindowed - windowed)
        print(f"  the long request (positions {P}..{len(ids) - 1}): |served - packed forward| "
              f"mean {gap.mean():.4f}, max {gap.max():.4f} (tolerance on the mean "
              f"{LOGP_MEAN_TOL}); without the windows the forward moves by mean "
              f"{lost.mean():.4f}, max {lost.max():.4f} ({time.perf_counter() - t0:.1f} s)")
        if not gap.mean() <= LOGP_MEAN_TOL:
            raise AssertionError("served Gemma-2 logprobs disagree with the packed forward")
        if not lost.mean() > LOGP_MEAN_TOL:
            raise AssertionError("the window check cannot see a lost window")

        # rollouts and two PPO updates
        prompts = [rng.integers(0, V, int(rng.integers(FAMILY_PROMPT_LEN[0],
                                                       FAMILY_PROMPT_LEN[1] + 1))).tolist()
                   for _ in range(TRAIN_PROMPTS)]
        sp = dict(max_new_tokens=FAMILY_NEW, min_new_tokens=FAMILY_NEW, temperature=1.0,
                  top_p=1.0)
        bodies = [dict(rid=f"p{i}g{j}", input_ids=p, sampling_params=sp)
                  for i, p in enumerate(prompts) for j in range(GROUP)]
        m0 = get(port, "/metrics")
        t0 = time.perf_counter()
        results = post(port, "/generate_batch", {"requests": bodies})["results"]
        wall = time.perf_counter() - t0
        m1 = get(port, "/metrics")
        steps = m1["decode_steps"] - m0["decode_steps"]
        roll_launches = m1["ragged_kernel_launches"] - m0["ragged_kernel_launches"]
        launches += roll_launches
        print(f"  rollouts: {len(results)} x {FAMILY_NEW} tokens in {wall:.2f} s; ragged "
              f"{roll_launches} = {L} x {steps} decode steps")
        if steps == 0 or roll_launches != L * steps:
            raise AssertionError("Gemma-2 rollouts missed K2 in a decode layer")
        rewards = [float(r["output_tokens"][-1] % 2 == 0) for r in results]
        batch = rollout_batch(results, [b["input_ids"] for b in bodies], rewards)

        t0 = time.perf_counter()
        actor = TorchPPOActor(PPOActorConfig(
            init_from_scratch=False, path=ckpt_dir, dtype="bfloat16",
            gradient_checkpointing=True, group_size=GROUP, ppo_n_minibatches=2,
            use_decoupled_loss=True, recompute_logprob=True, pack_length_quantum=ROW_LEN,
            max_pack_length=ROW_LEN,
            adv_norm=NormConfig(mean_level="group", std_level="group"),
            optimizer=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ))
        actor.initialize(ft_spec=FinetuneSpec(1, len(bodies), len(bodies)))
        torch.cuda.synchronize()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card")
        flash0 = flash_counts()
        batch["prox_logp"] = actor.compute_logp(batch)
        mask = np.roll(batch["loss_mask"] > 0, -1, axis=-1)
        dlp = np.abs(batch["prox_logp"][mask] - np.roll(batch["logprobs"], -1, axis=-1)[mask])
        print(f"  |trainer - server| logprob: mean {dlp.mean():.4f}, max {dlp.max():.4f} "
              f"(tolerance on the mean {LOGP_MEAN_TOL})")
        if not dlp.mean() <= LOGP_MEAN_TOL:
            raise AssertionError("Gemma-2 trainer logprobs disagree with the server's")
        actor.compute_advantages(batch)
        view = {k: batch[k] for k in actor.actor.LOSS_KEYS if k in batch}
        mb_tokens = [int(mb["attention_mask"].sum()) for mb in split_padded_tensor_dict_into_mb_list(
            view, n_mbs=actor.config.ppo_n_minibatches).mbs]
        stats = actor.ppo_update(batch)
        for i, (st, toks) in enumerate(zip(stats, mb_tokens)):
            st["tokens_per_s"] = toks / st["step_time"]
            print(f"  update {i}: loss {st['loss']:+.5f} grad_norm {st['grad_norm']:.4f} "
                  f"step_time {st['step_time']:.3f} s train tokens/s {st['tokens_per_s']:.1f} "
                  f"mfu {st.get('mfu', float('nan')):.4f} ({toks} tokens)")
            if not all(np.isfinite(st[k]) for k in ("loss", "grad_norm", "step_time")):
                raise AssertionError("a Gemma-2 PPO update returned a non-finite stat")
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
              "(torch.cuda.max_memory_allocated, server and trainer)")
        if flash_counts() != flash0:
            raise AssertionError("Gemma-2 training launched the flash kernels: per-layer "
                                 "windows take naive attention, as in JAX")

        actor.set_version(1)
        t0 = time.perf_counter()
        actor.update_weights(WeightUpdateMeta(type="disk", path=publish_dir))
        reply = post(port, "/update_weights_from_disk", {"path": publish_dir, "version": 1})
        print(f"  published and reloaded in {time.perf_counter() - t0:.1f} s: {reply}")
        snap = dict(safetensors_io.iter_safetensors(os.path.join(publish_dir, "v1")))
        params = dict(actor.model.named_parameters())
        if reply.get("version") != 1 or get(port, "/health")["version"] != 1:
            raise AssertionError("the Gemma-2 server did not take the trainer's version")
        if set(snap) != set(params) or not all(
                torch.equal(snap[n].to(p.device), p.detach().to(torch.bfloat16))
                for n, p in params.items()):
            raise AssertionError("the Gemma-2 snapshot is not the trainer's params in bf16")
        del snap
        out = post(port, "/generate", dict(input_ids=prompts[0], sampling_params=greedy))
        if len(out["output_tokens"]) != FAMILY_NEW or out["version"] != 1:
            raise AssertionError("the reloaded Gemma-2 server did not answer")
        print(f"  snapshot equals the trainer's {len(params)} params in bf16; a greedy request "
              f"on the new weights: {FAMILY_NEW} tokens, version {out['version']}")
        actor.destroy()
        del actor, params
        torch.cuda.empty_cache()
    ragged0 = ragged_paged_attention.launches
    tok_s = decode_rate(engine)
    print(f"  Gemma-2-2B decode {tok_s:.1f} tokens/s ({FAMILY_SLOTS} slots, 512-token prompts, "
          f"greedy); a decode step {1e3 * FAMILY_SLOTS / tok_s:.2f} ms of wall")
    launches += ragged_paged_attention.launches - ragged0
    del engine
    torch.cuda.empty_cache()
    return launches, stats, tok_s


# ---------------------------------------------------------------------------
# Gemma-1 (Gemma-2B) at full width: K1 at head dim 256 and the remat rungs
# ---------------------------------------------------------------------------

# google/gemma-2b config.json: the keys the port reads
GEMMA_2B = {
    "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
    "vocab_size": 256000, "hidden_size": 2048, "intermediate_size": 16384,
    "num_hidden_layers": 18, "num_attention_heads": 8, "num_key_value_heads": 1,
    "head_dim": 256, "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "hidden_act": "gelu", "attention_bias": False,
    "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
}
GEMMA1_SLOTS, GEMMA1_SEQ, GEMMA1_NEW = 8, 2048, 128
# Gemma-2B's 18 layers cut to 6, the least depth that one and two and three
# layers a checkpoint divide (the rung ladder)
GEMMA1_LAYERS = 6
GEMMA1_PROMPT_LEN = (128, 512)
GEMMA1_HEADS = dict(Hq=8, Hkv=1, hd=256)  # Gemma-2B: MQA, 8 q heads on one kv head
GEMMA7B_HEADS = dict(Hq=16, Hkv=16, hd=256)  # Gemma-7B: MHA
GEMMA1_DECODE = dict(B=GEMMA1_SLOTS, **GEMMA1_HEADS)
LADDER_ROWS = 8  # the rung ladder's batch: 8 packed 1024-token rows, one micro-batch
# (remat_policy, layer_group_size); the first is the one the others must equal
RUNG_LADDER = (("full", 1), ("save_attn", 1), ("save_mlp", 1), ("dots", 1),
               ("carry_offload", 1), ("full", 2), ("full", 3))
# attention forwards a layer in one update of one micro-batch: the rungs
# that keep the attention output launch none in the recompute
RUNG_K1A = {"full": 2, "save_mlp": 2, "dots": 2, "save_attn": 1, "carry_offload": 1}


def flash_counts_hd(hd):
    return tuple(w.launches_hd[hd] for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv))


def ladder_view(batch, loss_keys):
    """The longest prefix of the batch's sequences that packs into
    LADDER_ROWS rows of ROW_LEN (the engine's first-fit-decreasing)."""
    from areal_tpu_torch.utils.data import pack_into_rows

    view = {k: batch[k] for k in loss_keys if k in batch}
    best = 0
    for m in range(1, len(view["input_ids"]) + 1):
        rows = pack_into_rows({k: v[:m] for k, v in view.items()}, ROW_LEN).data["input_ids"]
        if rows.shape[0] > LADDER_ROWS:
            break
        best = m
    return {k: v[:best] for k, v in view.items()}


def rung_ladder(actor, batch, L):
    """From the actor's state after the phase's updates (masters, Adam's
    moments and count, parked in pinned host memory), one update on one
    batch of LADDER_ROWS packed rows under each (rung, layer group) of
    RUNG_LADDER.  Loss, grad norm and the updated masters must equal the
    first's (`full`, one layer a checkpoint) bit for bit; K1a must run
    RUNG_K1A[rung] times a layer.  Prints each one's memory (what the
    forward leaves for the backward beyond the actor's state, the peak
    before the optimizer step, the peak with it), its train_batch time and
    its K1a count.  Returns the flash launches at hd 256 (fwd, dq, dkv)
    summed over the ladder."""
    opt = actor._optimizer
    state = [p.data for p in opt.params] + opt.mu + opt.nu
    view = ladder_view(batch, actor.actor.LOSS_KEYS)
    rows, _, _ = actor._prepare_rows(view, 1)
    n_rows = rows.data["input_ids"].shape[0]
    tokens = int(view["attention_mask"].sum())
    t0 = time.perf_counter()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in state]
    for h, t in zip(host, state):
        h.copy_(t, non_blocking=True)
    torch.cuda.synchronize()
    count, steps = opt.count, actor.step_count
    print(f"  rung ladder: {len(view['input_ids'])} sequences, {tokens} tokens in {n_rows} rows "
          f"of {ROW_LEN}; the actor's state ({sum(t.numel() * t.element_size() for t in state) / 1e9:.1f} "
          f"GB: masters, mu, nu) parked in pinned host memory in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_rows != LADDER_ROWS:
        raise AssertionError(f"the ladder batch packs into {n_rows} rows, not {LADDER_ROWS}")
    base_cfg = actor.model_config
    ref = None
    total = np.zeros(3, np.int64)
    marks = {}
    call_model, step = actor._call_model, opt.step

    def marked_call(mb):
        out = call_model(mb)
        torch.cuda.synchronize()
        marks["held"] = torch.cuda.memory_allocated()
        return out

    def marked_step():
        marks["backward_peak"] = torch.cuda.max_memory_allocated()
        return step()

    actor._call_model, opt.step = marked_call, marked_step  # instance attributes, deleted below
    for rung, group in RUNG_LADDER:
        with torch.no_grad():
            for h, t in zip(host, state):
                t.copy_(h, non_blocking=True)
        opt.count, actor.step_count = count, steps
        actor.model_config = actor.model.cfg = base_cfg.replace(remat_policy=rung,
                                                                layer_group_size=group)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = flash_counts_hd(256)
        st = actor.actor._train_one_mb(view)
        torch.cuda.synchronize()
        got = np.subtract(flash_counts_hd(256), before)
        total += got
        peak = torch.cuda.max_memory_allocated() / 2**30
        if ref is None:
            ref = (st["loss"], st["grad_norm"],
                   [torch.empty(p.shape, dtype=p.dtype, pin_memory=True).copy_(p.data)
                    for p in opt.params])
            same = True
        else:
            same = (st["loss"] == ref[0] and st["grad_norm"] == ref[1] and all(
                torch.equal(p.data, r.to(p.device, non_blocking=True))
                for p, r in zip(opt.params, ref[2])))
        print(f"    {rung:13s} G={group}: loss {st['loss']:+.7f} grad_norm {st['grad_norm']:.7f} "
              f"train_batch {st['step_time']:.3f} s mfu {st.get('mfu', float('nan')):.4f}; "
              f"held after the forward {(marks['held'] - base) / 2**30:.2f} GiB over the state's "
              f"{base / 2**30:.2f}, peak {(marks['backward_peak']) / 2**30:.2f} GiB before the "
              f"step, {peak:.2f} GiB with it; K1a/K1b/K1c {tuple(int(x) for x in got)}; "
              f"loss, grad norm and masters bit-equal to full G=1: {same}")
        want = (RUNG_K1A[rung] * L, L, L)
        if tuple(got) != want:
            raise AssertionError(f"{rung} G={group}: flash launches {tuple(got)}, want {want}")
        if not same:
            raise AssertionError(f"{rung} G={group} differs from full G=1")
    actor.model_config = actor.model.cfg = base_cfg
    del actor._call_model, opt.step, host, ref
    return total


def gemma1_phase(ckpt_dir, publish_dir):
    """Gemma-2B at full width (GEMMA1_LAYERS of its 18 layers, d 2048, 8 q
    heads on one kv head of 256, vocab 256000), random bf16 weights from
    seed 0 written as an HF checkpoint by the port's writer: served through
    `gen.server.main` (8 slots, max_seq_len 2048), 8 prompts of 128..512
    tokens x group 4, 128 new tokens each over HTTP, K2 = layers x decode
    steps (/metrics); the PPO actor (f32 masters, bf16 compute, full remat)
    on the rollouts packed in 1024-token rows: the logprob recompute
    against the server's, 2 ppo_updates, every K1 launch at hd 256 on the
    tensor cores and exactly one K1a a layer and micro-batch in the
    recompute and two K1a, one K1b and one K1c in an update; a disk
    publish the server reloads (snapshot bit-equal to the trainer's bf16
    cast).  Then, the server stopped, the rung ladder
    (`rung_ladder`).  Returns the K2 launches, the flash launches at hd 256
    (recompute and updates, ladder), the update stats and one update
    micro-batch's packed segment ids."""
    cfg = write_checkpoint(dict(GEMMA_2B, num_hidden_layers=GEMMA1_LAYERS), ckpt_dir)
    shape = (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
             cfg.vocab_size, cfg.hidden_act, cfg.sliding_window, cfg.attn_impl)
    print(f"  from_hf: layers, d, q heads, kv heads, hd, vocab, act, window, attn_impl {shape}")
    want = (GEMMA1_LAYERS, 2048, 8, 1, 256, 256000, "gelu", None, "auto")
    if shape != want or not fa.flash_supported(
            ROW_LEN, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_):
        raise AssertionError("google/gemma-2b's config did not parse into the flash path's shape")
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, V, int(rng.integers(GEMMA1_PROMPT_LEN[0],
                                                   GEMMA1_PROMPT_LEN[1] + 1))).tolist()
               for _ in range(TRAIN_PROMPTS)]
    reset_flash_counts()
    counts = np.zeros(3, np.int64)
    t0 = time.perf_counter()
    with running_server(["--model-path", ckpt_dir, "--port", "0", "--n-slots",
                         str(GEMMA1_SLOTS), "--max-seq-len", str(GEMMA1_SEQ)]) as httpd:
        port = httpd.port
        print(f"  server up in {time.perf_counter() - t0:.1f} s "
              f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
        sp = dict(max_new_tokens=GEMMA1_NEW, min_new_tokens=GEMMA1_NEW, temperature=1.0,
                  top_p=1.0)
        bodies = [dict(rid=f"p{i}g{j}", input_ids=p, sampling_params=sp)
                  for i, p in enumerate(prompts) for j in range(GROUP)]
        m0 = get(port, "/metrics")
        t0 = time.perf_counter()
        results = post(port, "/generate_batch", {"requests": bodies})["results"]
        wall = time.perf_counter() - t0
        m1 = get(port, "/metrics")
        steps = m1["decode_steps"] - m0["decode_steps"]
        ragged = m1["ragged_kernel_launches"] - m0["ragged_kernel_launches"]
        print(f"  rollouts: {len(results)} x {GEMMA1_NEW} tokens in {wall:.2f} s "
              f"({len(results) * GEMMA1_NEW / wall:.1f} tokens/s); ragged {ragged} = {L} x "
              f"{steps} decode steps (/metrics)")
        for r in results:
            lp = np.asarray(r["output_logprobs"])
            if len(r["output_tokens"]) != GEMMA1_NEW or not (np.isfinite(lp).all()
                                                             and (lp <= 0).all()):
                raise AssertionError(f"a Gemma-2B request did not return {GEMMA1_NEW} "
                                     "finite logprobs")
        if steps == 0 or ragged != L * steps:
            raise AssertionError(f"Gemma-2B decode did not run its {L} layers through K2")
        rewards = [float(np.mean(np.asarray(r["output_tokens"]) % 2 == 0) > 0.5)
                   for r in results]
        batch = rollout_batch(results, [b["input_ids"] for b in bodies], rewards)

        t0 = time.perf_counter()
        actor = TorchPPOActor(PPOActorConfig(
            init_from_scratch=False, path=ckpt_dir, dtype="bfloat16",
            gradient_checkpointing=True, remat_policy="full", layer_group_size=1,
            group_size=GROUP, ppo_n_minibatches=2, use_decoupled_loss=True,
            recompute_logprob=True, pack_length_quantum=ROW_LEN, max_pack_length=ROW_LEN,
            adv_norm=NormConfig(mean_level="group", std_level="group"),
            optimizer=OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0),
        ))
        actor.initialize(ft_spec=FinetuneSpec(1, len(bodies), len(bodies)))
        torch.cuda.synchronize()
        print(f"  trainer up in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card")
        hd0, tc0 = flash_counts_hd(256), flash_counts_tc()
        before = flash_counts()
        t0 = time.perf_counter()
        batch["prox_logp"] = actor.compute_logp(batch)
        got = tuple(int(x) for x in np.subtract(flash_counts(), before))
        counts += got
        mask = np.roll(batch["loss_mask"] > 0, -1, axis=-1)
        dlp = np.abs(batch["prox_logp"][mask] - np.roll(batch["logprobs"], -1, axis=-1)[mask])
        print(f"  compute_logp in {time.perf_counter() - t0:.2f} s, flash launches fwd/dq/dkv "
              f"{got}; |trainer - server| logprob: mean {dlp.mean():.4f}, max {dlp.max():.4f} "
              f"(tolerance on the mean {LOGP_MEAN_TOL})")
        if got != (L, 0, 0):
            raise AssertionError(f"compute_logp did not run {L} flash forwards")
        if not dlp.mean() <= LOGP_MEAN_TOL:
            raise AssertionError("Gemma-2B trainer logprobs disagree with the server's")
        actor.compute_advantages(batch)
        view = {k: batch[k] for k in actor.actor.LOSS_KEYS if k in batch}
        mbs = split_padded_tensor_dict_into_mb_list(
            view, n_mbs=actor.config.ppo_n_minibatches).mbs
        mb_tokens = [int(mb["attention_mask"].sum()) for mb in mbs]
        seg_rows = actor._prepare_rows(mbs[0], actor.config.mb_spec.n_mbs)[1]["segment_ids"]
        stats = []
        torch.cuda.reset_peak_memory_stats()
        for step in range(2):
            before = flash_counts()
            st = actor.ppo_update(batch)
            got = tuple(int(x) for x in np.subtract(flash_counts(), before))
            counts += got
            n_mb = len(st) * actor.config.mb_spec.n_mbs
            want = (2 * L * n_mb, L * n_mb, L * n_mb)
            for s_, toks in zip(st, mb_tokens):
                s_["tokens_per_s"] = toks / s_["step_time"]
                print(f"  update {step}: loss {s_['loss']:+.5f} grad_norm {s_['grad_norm']:.4f} "
                      f"step_time {s_['step_time']:.3f} s train tokens/s "
                      f"{s_['tokens_per_s']:.1f} mfu {s_.get('mfu', float('nan')):.4f} "
                      f"({toks} tokens)")
                if not all(np.isfinite(s_[k]) for k in ("loss", "grad_norm", "step_time")):
                    raise AssertionError("a Gemma-2B PPO update returned a non-finite stat")
            print(f"    flash launches fwd/dq/dkv {got}, want {want} ({n_mb} micro-batches)")
            if got != want:
                raise AssertionError("a Gemma-2B training layer's attention missed the flash "
                                     "kernels")
            stats += st
        on_hd = tuple(int(x) for x in np.subtract(flash_counts_hd(256), hd0))
        on_tc = tuple(int(x) for x in np.subtract(flash_counts_tc(), tc0))
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB over the "
              f"updates (server and trainer); flash launches {tuple(int(c) for c in counts)}: "
              f"at hd 256 {on_hd}, on the tensor cores {on_tc}")
        if not on_hd == on_tc == tuple(int(c) for c in counts):
            raise AssertionError("a Gemma-2B flash launch missed the hd-256 tensor-core kernels")

        actor.set_version(1)
        t0 = time.perf_counter()
        actor.update_weights(WeightUpdateMeta(type="disk", path=publish_dir))
        reply = post(port, "/update_weights_from_disk", {"path": publish_dir, "version": 1})
        print(f"  published and reloaded in {time.perf_counter() - t0:.1f} s: {reply}")
        snap = dict(safetensors_io.iter_safetensors(os.path.join(publish_dir, "v1")))
        params = dict(actor.model.named_parameters())
        if reply.get("version") != 1 or get(port, "/health")["version"] != 1:
            raise AssertionError("the Gemma-2B server did not take the trainer's version")
        if set(snap) != set(params) or not all(
                torch.equal(snap[n].to(p.device), p.detach().to(torch.bfloat16))
                for n, p in params.items()):
            raise AssertionError("the Gemma-2B snapshot is not the trainer's params in bf16")
        del snap, params
        greedy = dict(max_new_tokens=32, min_new_tokens=32, temperature=0.0)
        out = post(port, "/generate", dict(input_ids=prompts[0], sampling_params=greedy))
        if len(out["output_tokens"]) != 32 or out["version"] != 1:
            raise AssertionError("the reloaded Gemma-2B server did not answer")
        m2 = get(port, "/metrics")
        ragged += m2["ragged_kernel_launches"] - m1["ragged_kernel_launches"]
        print(f"  snapshot equals the trainer's params in bf16; a greedy request on the new "
              f"weights: 32 tokens, version {out['version']}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  server stopped: {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    ladder = rung_ladder(actor, batch, L)
    actor.destroy()
    del actor
    gc.collect()
    torch.cuda.empty_cache()
    return ragged, tuple(int(c) for c in counts), tuple(int(c) for c in ladder), stats, seg_rows


def gemma1_timings(seg_rows):
    """K1a/b/c at hd 256 on the Gemma-2B phase's train rows (kernel, plain
    version, SDPA, bound), K2 at Gemma-2B's decode heads (8 slots, one kv
    head of 256, spans 128..639 of K 2048), and the offset kernels at
    Gemma-2B's heads per shard of phase 3's T = 2048 rows at sp 2 and 4.
    Returns time_flash's timings and errors."""
    print_k2(*decode_case_timed("gemma1"))
    print(f"  K1 at Gemma-2B's heads (Hq=8 Hkv=1 hd=256; dk/dv cluster of "
          f"{fa.dkv_plan(8, 1, 256, True, *np.shape(seg_rows))} blocks a key tile):")
    flash = time_flash(seg_rows, **GEMMA1_HEADS)
    for sp in (2, 4):
        time_flash_offset(packed_segments(2048, [700, 900, 300]).numpy(), sp=sp,
                          label=f"hd 256 T=2048 sp {sp}", **GEMMA1_HEADS)
    return flash


def gemma1_like_rows(seed=0):
    """Packed segment ids shaped like the gemma1 phase's train rows (for
    `--only kernels`, which runs no model): one micro-batch of 4 seeded
    prompts of GEMMA1_PROMPT_LEN tokens x group 4, each with GEMMA1_NEW new
    tokens, packed into 1024-token rows as the actor packs them."""
    from areal_tpu_torch.utils.data import pack_into_rows

    lens = np.repeat(np.random.default_rng(seed).integers(*GEMMA1_PROMPT_LEN, 4) + GEMMA1_NEW, 4)
    mask = np.arange(lens.max())[None, :] < lens[:, None]
    return pack_into_rows({"attention_mask": mask}, 1024,
                          rows_bucket_pow2=True).data["segment_ids"]


def dkv_cluster_sweep():
    """K1c at hd 256 on Gemma-2B's heads at every cluster size the kernel
    takes (its C entry called with each), by device time, on 4, 8 and 16
    of `gemma1_like_rows`' rows: the measurement `fa.dkv_plan`'s choice
    (marked) rests on."""
    rows = np.concatenate([gemma1_like_rows(0), gemma1_like_rows(1)])
    lib = fa._lib()
    for n in (4, 8, 16):
        seg = torch.from_numpy(np.ascontiguousarray(rows[:n])).to(torch.int32)
        qs, k, v, dout, sg = flash_case(300, seg, **GEMMA1_HEADS)
        out, lse = fa.flash_fwd(qs, k, v, sg)
        di = fa.attention_di(out, dout)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        pick = fa.dkv_plan(8, 1, 256, True, *seg.shape)
        times = []
        for cluster in (1, 2, 4, 8):
            def run(cluster=cluster):
                fa._raise(lib.flash_bwd_dkv(
                    0, 1, qs.data_ptr(), k.data_ptr(), v.data_ptr(), sg.data_ptr(),
                    sg.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), cluster,
                    *fa._rows(qs, k, None, None, 0)), "flash_bwd_dkv")

            times.append(f"{cluster}{'*' if cluster == pick else ''} "
                         f"{fmt_ms(device_ms(run, iters=20))}")
        print(f"  K1c hd 256 cluster sweep, {n} rows of 1024 ({attended_pairs(sg)} pairs a "
              f"q head), device time by blocks a key tile (* dkv_plan's): " + ", ".join(times))


def decode_case_timed(name):
    """(label, time_kernel's tuple) of one of the five decode shapes."""
    label, case, softcap = decode_case(name)
    return label, time_kernel(case, softcap)


def families_timings(qwen3_rows):
    """K2 at the families' decode shapes and K1 at Qwen3's heads on the
    Qwen3 loop's packed rows: kernel, plain version, SDPA, bound."""
    for name in ("gemma2", "qwen3"):
        print_k2(*decode_case_timed(name))
    print("  K1 at Qwen3-1.7B's heads (Hq=16 Hkv=8):")
    flash, errs = time_flash(qwen3_rows, **{k: QWEN3_HEADS[k] for k in ("Hq", "Hkv")})
    return errs


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# speculative decoding: K2's verify half at T = D + 1
# ---------------------------------------------------------------------------

SPEC_SLOTS, SPEC_SEQ, SPEC_NEW = 8, 1024, 128
SPEC_PROMPT_LEN = (64, 512)
SPEC_F32_LAYERS, SPEC_F32_NEW = 4, 64
# mean |logprob on - logprob off| over the positions before the first
# divergence, at 28 layers in bf16: a verify's projections are products of
# [B * (D + 1), d] rows where decode's are [B, d], and cuBLAS may take
# another algorithm for each, so a logit may round one bf16 step (2^-8
# relative) apart; as LOGP_MEAN_TOL, a few hundredths at most.
SPEC_LOGP_MEAN_TOL = 5e-2
# f32, TF32 off: per-token |logprob on - off|.  The products of a verify
# ([B * (D + 1), d] rows) and of decode ([B, d]) may round a row apart, and
# a last-bit difference compounds along a stream through the K/V it writes
# (on the CPU, a few 1e-6 at one token grew to 4e-4 over 64 tokens)
SPEC_F32_LOGP_TOL = 1e-3


def spec_requests(vocab, n, lens, new, seed, tag):
    """`n` requests over prompts of `lens` tokens made of a random span
    tiled (prompt lookup finds drafts there); even ones greedy, odd ones
    sampled at temperature 1.  Stream ids pinned, so the two servers key
    each request's sampler alike."""
    rng = np.random.default_rng(seed)
    bodies = []
    for i in range(n):
        length = int(rng.integers(*lens))
        span = rng.integers(0, vocab, int(rng.integers(16, 65))).tolist()
        ids = (span * (length // len(span) + 1))[:length]
        bodies.append(dict(rid=f"{tag}{i}", input_ids=ids, stream_id=1000 + i,
                           sampling_params=dict(max_new_tokens=new, min_new_tokens=new,
                                                temperature=0.0 if i % 2 == 0 else 1.0)))
    return bodies


def verify_case(seed, T, **kw):
    """A verify call's inputs at T = D + 1 (`ragged_case`): slot 2 drafts
    T - 3 tokens, slot 5 none (n_write 1), slots 3 and 6 are idle (every
    write dropped), the rest draft all T - 1; the mask is causal among
    the T rows."""
    case = ragged_case(seed, T=T, **kw)
    M = case["ck"].shape[1]
    widx = case["lengths"].long()[:, None] + torch.arange(T, device="cuda")[None, :]
    n_write = torch.full_like(case["lengths"], T)
    n_write[2], n_write[5] = T - 2, 1
    n_write[[3, 6]] = 0
    keep = torch.arange(T, device="cuda")[None, :] < n_write[:, None].long()
    case["widx"] = torch.where(keep, widx, M).to(torch.int32).contiguous()
    return case


def check_verify_kernel():
    """(a) K2 against its plain version at verify shapes, with short drafts
    and idle slots, on the variant the rule picks; the appended cache bit
    for bit.  tc: Qwen2.5-1.5B's heads and Gemma-2B's decode heads at T = 4
    and 8 (24 to 64 rows a kv head); dec: Qwen3-1.7B's and Gemma-2-2B's at
    T = 4 and 8 (8 and 16 rows); the passes: Qwen2.5's at T = 16 (96
    rows).  Returns max|out - plain|."""
    worst = 0.0
    for i, (label, kw, softcap) in enumerate((
            ("Qwen2.5-1.5B heads (B=8 Hq=12 Hkv=2 hd=128) K=1024",
             dict(B=SPEC_SLOTS, K=1024, M=1024), None),
            ("Gemma-2B decode heads (B=8 Hq=8 Hkv=1 hd=256) K=2048", dict(GEMMA1_DECODE), None),
            ("Qwen3-1.7B heads (B=8 Hq=16 Hkv=8 hd=128) K=1024",
             dict(B=SPEC_SLOTS, K=1024, M=1024, **QWEN3_HEADS), None),
            ("Gemma-2-2B decode heads (B=8 Hq=8 Hkv=4 hd=256) K=2048, softcap 50",
             dict(GEMMA_DECODE, K=2048, M=2048), 50.0))):
        for T in (4, 8):
            err = compare_ragged(f"verify T={T}, {label}, n_write < T and idle slots",
                                 verify_case(300 + 10 * i + T, T, **kw), softcap)
            worst = max(worst, err)
    # the CUDA-core passes: a draft of 15 at Qwen2.5's heads (96 query rows
    # a kv head, past the tensor-core kernel's 64)
    err = compare_ragged("verify T=16, Qwen2.5-1.5B heads K=1024: 96 rows a kv head, n_write "
                         "< T and idle slots", verify_case(330, 16, B=SPEC_SLOTS, K=1024,
                                                           M=1024))
    return max(worst, err)


def spec_f32_streams(cfg):
    """(b) In process, f32 weights and cache, TF32 off, SPEC_F32_LAYERS
    layers of full width: spec off, spec_draft_len 3 and the adaptive
    ladder, on one workload of greedy and sampled requests.  Token streams
    must be equal, logprobs within SPEC_F32_LOGP_TOL, every accepted
    draft the token the sampler drew at its position, and K2 launches
    layers x (decode steps + verify calls).  Returns the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg4 = cfg.replace(num_layers=SPEC_F32_LAYERS, dtype="float32")
    model = init_params(cfg4, 0, "cuda")
    bodies = spec_requests(cfg.vocab_size, SPEC_SLOTS, (64, 257), SPEC_F32_NEW, 41, "f")
    launches, runs = 0, {}
    for label, kw in (("off", {}), ("D=3", dict(spec_decode=True, spec_draft_len=3)),
                      ("ladder (0, 3, 7)", dict(spec_decode=True))):
        eng = GenEngine(cfg4, params=model, n_slots=SPEC_SLOTS, max_seq_len=SPEC_SEQ,
                        prompt_bucket=128, kv_dtype="float32", seed=0, **kw)
        checked = record_verifies(eng)
        reqs = [GenRequest(rid=b["rid"], input_ids=b["input_ids"], stream_id=b["stream_id"],
                           **b["sampling_params"]) for b in bodies]
        l0 = ragged_paged_attention.launches
        v0 = ragged_paged_attention.launches_verify
        on_tc0 = k2_variant_counts()[:2]
        eng.generate_blocking(reqs)
        n = ragged_paged_attention.launches - l0
        n_verify = ragged_paged_attention.launches_verify - v0
        if (k2_variant_counts()[:2] != on_tc0).any():
            raise AssertionError(f"spec {label}: an f32 K2 launch ran on the tensor cores")
        st = eng.stats
        want = SPEC_F32_LAYERS * (st["decode_steps"] + st["verify_calls"])
        print(f"  f32 {SPEC_F32_LAYERS} layers, spec {label}: drafted {st['spec_drafted']}, "
              f"accepted {st['spec_accepted']}, verify calls {st['verify_calls']}, decode "
              f"steps {st['decode_steps']}; K2 launches {n} = {SPEC_F32_LAYERS} x (decode "
              f"steps + verify calls) = {want}, of them at T > 1 {n_verify}; accepted drafts "
              f"checked {checked[0]}")
        if n != want or n_verify != SPEC_F32_LAYERS * st["verify_calls"]:
            raise AssertionError(f"spec {label}: K2 launches != layers x (decode steps + "
                                 "verify calls), or those at T > 1 != layers x verify calls")
        if kw and (st["verify_calls"] == 0 or st["spec_drafted"] == 0):
            raise AssertionError(f"spec {label}: nothing was drafted or verified")
        launches += n
        runs[label] = reqs
        del eng
    worst = 0.0
    for label in ("D=3", "ladder (0, 3, 7)"):
        for a, b in zip(runs["off"], runs[label]):
            gap = float(np.max(np.abs(np.subtract(a.output_logprobs, b.output_logprobs))))
            worst = max(worst, gap)
            if a.output_tokens != b.output_tokens or gap > SPEC_F32_LOGP_TOL:
                raise AssertionError(f"f32 request {a.rid}: spec {label} differs from spec off "
                                     f"(tokens equal {a.output_tokens == b.output_tokens}, "
                                     f"max |dlogprob| {gap:.2e})")
    print(f"  f32 token streams (4 greedy, 4 sampled, {SPEC_F32_NEW} tokens) equal with spec "
          f"off, D=3 and the ladder; max |logprob on - off| {worst:.3e} (tolerance "
          f"{SPEC_F32_LOGP_TOL})")
    del model
    torch.cuda.empty_cache()
    return launches


def record_verifies(eng):
    """Wrap the engine's verify so each call checks, slot by slot, that
    every accepted draft is the token the sampler drew at its position
    (the delivered rows).  Returns a one-element list counting the
    checked drafts."""
    inner = eng._dispatch_verify
    checked = [0]

    def wrapped(st, active, d, drafts, dlens):
        out, n_emit = inner(st, active, d, drafts, dlens)
        toks = out[0].astype(np.int64)  # [T, slots]
        for s in active:
            a = int(n_emit[s]) - 1
            if a > dlens[s] or not np.array_equal(toks[:a, s], drafts[s, :a]):
                raise AssertionError(f"slot {s}: an accepted draft is not the sampled token")
            checked[0] += a
        return out, n_emit

    eng._dispatch_verify = wrapped
    return checked


def spec_servers(ckpt_dir):
    """(c) `python -m areal_tpu_torch.gen.server` on the bf16 checkpoint
    `ckpt_dir`, with --spec-decode and without (the launch helper, 8
    slots), each sent the same 8 requests at once.  Returns the launches
    the servers counted: (the spec server's at T > 1, both servers' at
    T = 1, the servers' figures)."""
    from areal_tpu_torch.api.config import GenServerConfig
    from areal_tpu_torch.launcher.local import LocalLauncher
    from areal_tpu_torch.scripts.bench_e2e_grpo import server_metrics
    from areal_tpu_torch.utils.telemetry import parse_prometheus_text

    cfg = TransformerConfig.from_hf(ckpt_dir)
    L = cfg.num_layers
    bodies = spec_requests(cfg.vocab_size, SPEC_SLOTS, SPEC_PROMPT_LEN, SPEC_NEW, 42, "s")
    launchers = {k: LocalLauncher(os.path.join(ROOT, "build", f"spec_logs_{k}"))
                 for k in ("off", "on")}
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = {k: pool.submit(launchers[k].start_gen_servers, GenServerConfig(
                model_path=ckpt_dir, dtype="bfloat16", max_seqs=SPEC_SLOTS,
                max_context_len=SPEC_SEQ, page_size=128, random_seed=0,
                spec_decode=(k == "on"))) for k in launchers}
            addrs = {k: f.result()[0] for k, f in futs.items()}
        print(f"  both server processes up in {time.perf_counter() - t0:.1f} s")
        res, figs = {}, {}
        for k in ("off", "on"):
            addr = addrs[k]
            m0 = server_metrics(addr)
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
                res[k] = list(pool.map(lambda b, a=addr: post_addr(a, "/generate", b), bodies))
            wall = time.perf_counter() - t1
            m1 = server_metrics(addr)
            d = {key: m1[key] - m0[key] for key in (
                "decode_steps", "verify_calls", "spec_drafted", "spec_accepted",
                "ragged_kernel_launches", "ragged_verify_launches", "tokens_generated")}
            want = L * (d["decode_steps"] + d["verify_calls"])
            figs[k] = dict(d, wall=wall, tok_s=sum(len(r["output_tokens"]) for r in res[k]) / wall)
            rate = d["spec_accepted"] / d["spec_drafted"] if d["spec_drafted"] else 0.0
            print(f"  spec {k}: 8 x {SPEC_NEW} tokens in {wall:.2f} s = {figs[k]['tok_s']:.1f} "
                  f"tokens/s (prefill included); decode steps {d['decode_steps']}, verify calls "
                  f"{d['verify_calls']}, drafted {d['spec_drafted']}, accepted "
                  f"{d['spec_accepted']} (rate {rate:.3f}); K2 launches "
                  f"{d['ragged_kernel_launches']} = {L} x (decode steps + verify "
                  f"calls) = {want}, of them at T > 1 {d['ragged_verify_launches']} = "
                  f"{L} x verify calls")
            if (d["ragged_kernel_launches"] != want
                    or d["ragged_verify_launches"] != L * d["verify_calls"]):
                raise AssertionError(f"spec {k}: K2 launches != {L} x (decode steps + "
                                     f"verify calls), or those at T > 1 != {L} x verify calls")
            for b, r in zip(bodies, res[k]):
                lp = np.asarray(r["output_logprobs"], np.float64)
                if len(r["output_tokens"]) != SPEC_NEW or not (np.isfinite(lp).all()
                                                              and (lp <= 0).all()):
                    raise AssertionError(f"spec {k} {b['rid']}: not {SPEC_NEW} tokens with "
                                         "finite logprobs <= 0")
        if figs["on"]["verify_calls"] == 0 or figs["on"]["spec_drafted"] == 0:
            raise AssertionError("the --spec-decode server drafted or verified nothing")
        if figs["off"]["verify_calls"] != 0:
            raise AssertionError("the server without --spec-decode ran a verify")
        with urllib.request.urlopen(f"http://{addrs['on']}/metrics?format=prometheus",
                                    timeout=60) as resp:
            parsed = parse_prometheus_text(resp.read().decode())
    finally:
        for launcher in launchers.values():
            launcher.stop_all()
    for name in ("areal_gen_spec_drafted_total", "areal_gen_spec_accepted_total",
                 "areal_gen_verify_calls_total", "areal_gen_spec_acceptance_rate"):
        if name not in parsed:
            raise AssertionError(f"/metrics?format=prometheus lacks {name}")
    rates = parsed["areal_gen_spec_acceptance_rate"]
    tier0 = rates.get('{tier="0"}')
    if tier0 is None:
        raise AssertionError('no {tier="0"} acceptance rate on the Prometheus surface')
    print(f"  Prometheus: verify calls {parsed['areal_gen_verify_calls_total']['']:.0f}, "
          f"drafted {parsed['areal_gen_spec_drafted_total']['']:.0f}, accepted "
          f"{parsed['areal_gen_spec_accepted_total']['']:.0f}, acceptance rate "
          f"{rates['']:.4f} (tier 0, windowed: {tier0:.4f})")
    gaps, firsts = [], []
    for a, b in zip(res["off"], res["on"]):
        first = next((j for j, (x, y) in enumerate(zip(a["output_tokens"], b["output_tokens"]))
                      if x != y), SPEC_NEW)
        firsts.append(first)
        gaps.extend(np.abs(np.subtract(a["output_logprobs"][:first],
                                       b["output_logprobs"][:first])).tolist())
    gaps = np.asarray(gaps)
    print(f"  on against off (bf16, {L} layers): first divergent position per request "
          f"{firsts} ({SPEC_NEW} = none); logprob |diff| before it: mean {gaps.mean():.5f}, "
          f"max {gaps.max():.5f} over {gaps.size} tokens (tolerance: mean "
          f"{SPEC_LOGP_MEAN_TOL}). Acceptance on random weights says nothing about a "
          "trained model's.")
    if gaps.mean() > SPEC_LOGP_MEAN_TOL:
        raise AssertionError("spec on and off logprobs differ beyond bf16 rounding")
    return (figs["on"]["ragged_verify_launches"],
            sum(f["ragged_kernel_launches"] - f["ragged_verify_launches"] for f in figs.values()),
            figs)


def spec_timings():
    """(d) K2 at T = 4 and 8 at the spec servers' shape (8 slots, Qwen2.5's
    heads, K 1024, spans 64..640, every slot drafting), by CUDA events and
    the profiler, with its bound, plain version and SDPA on the same
    [B, Hq, T, K] boolean mask.  Returns {T: time_kernel's tuple}."""
    out = {}
    lengths = torch.from_numpy(np.random.default_rng(3).integers(64, 641, SPEC_SLOTS)).to(
        torch.int32)
    for T in (4, 8):
        case = ragged_case(400 + T, B=SPEC_SLOTS, T=T, K=1024, M=1024, lengths=lengths)
        case["widx"] = (case["lengths"].long()[:, None]
                        + torch.arange(T, device="cuda")[None, :]).to(torch.int32).contiguous()
        tc0 = ragged_paged_attention.launches_tc
        _run(ragged_paged_attention, case)
        if ragged_paged_attention.launches_tc != tc0 + 1:
            raise AssertionError(f"the bf16 verify at T={T} did not run on the tensor cores")
        t = time_kernel(case)
        out[T] = t
        print(f"  verify T={T} (B=8 Hq=12 Hkv=2 hd=128, K=1024): kernel {t[0]:.4f} ms, plain "
              f"{t[1]:.4f} ms, SDPA {t[2]:.4f} ms, bound {t[3]:.4f} ms ({t[4]}); device time "
              f"per call: kernel {fmt_ms(t[5])}, SDPA {fmt_ms(t[6])}")
    return out


def spec_phase(ckpt_dir):
    """The spec phase: (a) to (d) above.  Returns (max|err| of the kernel
    checks, verify launches, T=1 launches of the servers, f32 launches,
    timings)."""
    err = check_verify_kernel()
    f32_launches = spec_f32_streams(qwen25_1p5b().replace(eos_token_id=None))
    verify_launches, decode_launches, _ = spec_servers(ckpt_dir)
    return err, verify_launches, decode_launches, f32_launches, spec_timings()


def cuda_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(prof):
    """The device kernels of a torch.profiler run, by name, with their self
    device time (microseconds)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


# profiler windows a device_ms fallback may take before "not measured"
DEVICE_MS_WINDOWS = 3


def device_ms(fn, iters=50):
    """Device time per call of `fn`, leaving out the host's share (Python,
    the launch path) that `cuda_ms` includes when the host is slower than
    the device.  The `iters` calls are captured into one CUDA graph and
    replayed back to back, timed by CUDA events around the replay.

    Not torch.profiler first: after a window of tens of thousands of
    launches (the train phase's update window, the grpo phase's interrupt
    run) the profiler loses kernel records for the rest of the process,
    its own kernels' and the port's alike (a 40,000-launch window cost
    every later window 1 record in 20, a 400,000-launch one half of them;
    the whole script then read low device times, and none at all from the
    families phase on).  Where `fn` cannot be captured, a profiler window
    is taken, and kept only when every kernel was recorded a whole number
    of times per call; else it is taken again, up to DEVICE_MS_WINDOWS in
    all, and None when none was whole."""
    fn()
    torch.cuda.synchronize()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    except RuntimeError as exc:
        torch.cuda.synchronize()
        print(f"  device time by the profiler: the calls could not be captured "
              f"({str(exc).splitlines()[0][:120]})")
    for attempt in range(DEVICE_MS_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if kernels and all(e.count % iters == 0 for e in kernels):
            return sum(e.self_device_time_total for e in kernels) / iters / 1e3
        print(f"  profiler window {attempt + 1} of {DEVICE_MS_WINDOWS} lost kernel records "
              f"({sum(e.count for e in kernels)} launches recorded for {iters} calls)")
    return None


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def kernel_bound(case):
    """Least time for the work: bytes moved (each input read once, each
    output written once; the K/V pages of each slot's copied span) over
    the HBM rate, and the QK and PV flops over the peak rate for the
    inputs' type; the larger."""
    q, ck = case["q"], case["ck"]
    B, T, Hq, hd = q.shape
    Hkv = ck.shape[2]
    K = min(case["key_window"], ck.shape[1])
    end = _copied_end(case["lengths"], T, K, min(case["page_size"], K)).sum().item()
    kv_item = ck.element_size()
    nbytes = (2 * q.numel() * q.element_size()  # q in, out
              + 4 * case["k_new"].numel() * kv_item  # k/v new in, appended out
              + 2 * end * Hkv * hd * kv_item  # K and V pages read
              + case["mask"].numel() + 4 * (2 * B + B * T))  # mask, rows, lengths, widx
    flops = 4 * end * Hkv * T * (Hq // Hkv) * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


DECODE_SHAPES = ("serving", "full window", "gemma2", "qwen3", "gemma1")


def decode_case(name):
    """One of the five T = 1 decode shapes the timings read: "serving" and
    "full window" (Qwen2.5-1.5B, phase 6), "gemma2" and "qwen3" (the
    families' decode grids, phase 11), "gemma1" (Gemma-2B, phase 12).
    Returns (label, case, softcap)."""
    rng = np.random.default_rng
    if name == "serving":
        lengths = torch.from_numpy(rng(2).integers(64, 965, 16)).to(torch.int32)
        return ("serving shape (B=16 T=1 K=1024, spans 64..964)",
                ragged_case(7, K=1024, lengths=lengths), None)
    if name == "full window":
        return "full window (B=16 T=1 K=2048, random spans)", ragged_case(8, K=2048), None
    if name == "gemma2":
        lo, hi = LONG_PROMPT - 512, LONG_PROMPT + FAMILY_NEW
        lengths = torch.from_numpy(rng(12).integers(lo, hi, GEMMA_DECODE["B"])).to(torch.int32)
        return (f"Gemma-2-2B decode (B={GEMMA_DECODE['B']} K={FAMILY_SEQ}, spans "
                f"{lo}..{hi - 1}, window 4096, softcap 50; SDPA uncapped)",
                ragged_case(13, K=FAMILY_SEQ, M=FAMILY_SEQ, lengths=lengths, window=4096,
                            **GEMMA_DECODE), 50.0)
    if name == "qwen3":
        hi = GRPO_PROMPT_LEN[1] + NEW_TOKENS
        lengths = torch.from_numpy(rng(14).integers(GRPO_PROMPT_LEN[0], hi, GRPO_SLOTS)).to(
            torch.int32)
        return (f"Qwen3-1.7B decode (B={GRPO_SLOTS} K={GRPO_SEQ}, spans "
                f"{GRPO_PROMPT_LEN[0]}..{hi - 1})",
                ragged_case(15, B=GRPO_SLOTS, K=GRPO_SEQ, M=GRPO_SEQ, lengths=lengths,
                            **QWEN3_HEADS), None)
    hi = GEMMA1_PROMPT_LEN[1] + GEMMA1_NEW
    lengths = torch.from_numpy(rng(22).integers(GEMMA1_PROMPT_LEN[0], hi, GEMMA1_SLOTS)).to(
        torch.int32)
    return (f"Gemma-2B decode (B={GEMMA1_SLOTS} Hq=8 Hkv=1 hd=256, K={GEMMA1_SEQ}, spans "
            f"{GEMMA1_PROMPT_LEN[0]}..{hi - 1})",
            ragged_case(23, K=GEMMA1_SEQ, M=GEMMA1_SEQ, lengths=lengths, **GEMMA1_DECODE), None)


def print_k2(label, t):
    print(f"  K2 at {label}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, SDPA {t[2]:.4f} ms, "
          f"bound {t[3]:.4f} ms ({t[4]}); device time per call: kernel {fmt_ms(t[5])}, "
          f"SDPA {fmt_ms(t[6])}")


def time_kernel(case, softcap=None):
    """(kernel ms, plain ms, SDPA ms, bound ms, bound_by, kernel device ms,
    SDPA device ms) on one case.  SDPA has no softcap: under one it times
    the same attention uncapped."""
    args = dict(case, logit_softcap=softcap)
    kern = cuda_ms(lambda: ragged_paged_attention(**args))
    plain = cuda_ms(lambda: ragged_paged_attention_plain(**args), iters=50)
    # SDPA on the same inputs, gathered and GQA-expanded outside the timing
    q, ck, cv = case["q"], case["ck"], case["cv"]
    B, T, Hq, hd = q.shape
    K = case["key_window"]
    group = Hq // ck.shape[2]
    rows = case["rows"].long()
    k = ck[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    v = cv[rows, :K].transpose(1, 2).repeat_interleave(group, dim=1)
    qs = q.transpose(1, 2)
    m = case["mask"][:, None]
    def lib():
        return torch.nn.functional.scaled_dot_product_attention(qs, k, v, attn_mask=m)

    sdpa = cuda_ms(lib)
    bound, by = kernel_bound(case)
    return (kern, plain, sdpa, bound, by,
            device_ms(lambda: ragged_paged_attention(**args)), device_ms(lib))


FLASH_REPLACES = {
    "flash_fwd": "areal_tpu/ops/attention.py:176 (splash forward, "
                 "splash_attention_kernel.py:1137, jax 0.9.0)",
    "flash_bwd_dq": "areal_tpu/ops/attention.py:176 (splash dq, "
                    "splash_attention_kernel.py:1635, jax 0.9.0)",
    "flash_bwd_dkv": "areal_tpu/ops/attention.py:176 (splash dk/dv, "
                     "splash_attention_kernel.py:2196, jax 0.9.0)",
}


def attended_pairs(seg: torch.Tensor) -> int:
    """Causal (query, key) pairs inside segments, summed over rows: what
    the kernels must compute for one q head."""
    pairs = 0
    for row in seg.cpu().numpy():
        _, n = np.unique(row[row >= 0], return_counts=True)
        pairs += int((n * (n + 1) // 2).sum())
    return pairs


def flash_bounds(qs, k, seg):
    """Least time of each kernel for these inputs: bytes over the HBM rate
    against operations (the attended pairs) over the bf16 peak; the larger,
    with its kind.  Bytes: the segment ids in full, the inputs the function
    needs once each (q, dout, k, v, lse and di at valid tokens only: no
    pair touches padding), the outputs (out, lse, dq, dk, dv) written once
    in full, pad rows included."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    item = qs.element_size()
    n_valid = int((seg >= 0).sum())
    q_in, kv_in, row_in = n_valid * Hq * hd * item, n_valid * Hkv * hd * item, n_valid * Hq * 4
    q_out, kv_out, row_out = qs.numel() * item, k.numel() * item, B * Hq * T * 4
    n_seg = seg.numel() * 4
    ops = attended_pairs(seg) * Hq * hd
    work = {  # (bytes, flops)
        "flash_fwd": (n_seg + q_in + 2 * kv_in + q_out + row_out, 4 * ops),
        "flash_bwd_dq": (n_seg + 2 * q_in + 2 * kv_in + 2 * row_in + q_out, 6 * ops),
        "flash_bwd_dkv": (n_seg + 2 * q_in + 2 * kv_in + 2 * row_in + 2 * kv_out, 8 * ops),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[qs.dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def time_flash(seg_rows, Hq=12, Hkv=2, hd=128):
    """On the packed rows `seg_rows` at `Hq` q heads over `Hkv` kv heads
    of `hd` (default: Qwen2.5's) in bf16: each flash
    kernel against its plain version (`compare_flash`), then the kernel,
    the plain version and torch SDPA timed: SDPA's forward for the forward
    kernel, its forward + backward through autograd for the two backward
    kernels (one library call computes all of dq, dk, dv), by CUDA events
    and by device time.  Returns the timings and the |kernel - plain| of
    each kernel."""
    seg = torch.from_numpy(np.ascontiguousarray(seg_rows)).to(torch.int32)
    qs, k, v, dout, sg = flash_case(300, seg, Hq=Hq, Hkv=Hkv, hd=hd)
    errs = compare_flash(f"train rows {tuple(seg.shape)}", qs, k, v, dout, sg)
    out, lse = fa.flash_fwd(qs, k, v, sg)
    di = fa.attention_di(out, dout)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(qs, k, v, sg),
                      lambda: fa.flash_fwd_plain(qs, k, v, sg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di),
                         lambda: fa.flash_bwd_dq_plain(qs, k, v, sg, dout, lse, di)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di),
                          lambda: fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, lse, di)),
    }
    # SDPA on the same rows: [B, H, T, hd], a boolean block-diagonal causal
    # mask (pad queries see themselves, so no row is empty); q_s is already
    # scaled, so SDPA's own scale is 1
    B, T, Hq, hd = qs.shape
    idx = torch.arange(T, device=sg.device)
    same = (sg[:, :, None] == sg[:, None, :]) & (sg[:, :, None] >= 0)
    mask = (same & (idx[None, :] <= idx[:, None])) | torch.eye(T, dtype=torch.bool,
                                                                device=sg.device)
    mask = mask[:, None]
    q4 = qs.transpose(1, 2).detach().requires_grad_(True)
    k4 = k.transpose(1, 2).detach().requires_grad_(True)
    v4 = v.transpose(1, 2).detach().requires_grad_(True)
    g4 = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True)

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True),
                            (q4, k4, v4), g4)

    lib = {"flash_fwd": cuda_ms(lib_fwd, iters=20, warmup=3)}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cuda_ms(lib_fwd_bwd, iters=10, warmup=2)
    dev = {name: device_ms(kernel, iters=20) for name, (kernel, _) in runs.items()}
    print("  device time per call (graph replay): " + ", ".join(
        f"{name} {fmt_ms(t)}" for name, t in dev.items())
        + f"; SDPA forward {fmt_ms(device_ms(lib_fwd, iters=20))}, SDPA forward + backward "
          f"{fmt_ms(device_ms(lib_fwd_bwd, iters=10))}")
    bounds = flash_bounds(qs, k, sg)
    timings = {}
    for name, (kernel, plain) in runs.items():
        ms = cuda_ms(kernel, iters=20, warmup=3)
        plain_ms = cuda_ms(plain, iters=5, warmup=1)
        timings[name] = (ms, plain_ms, lib[name], *bounds[name])
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{lib[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    print(f"  rows {B} x {T}, {int((sg >= 0).sum())} tokens, "
          f"{attended_pairs(sg)} attended pairs per q head")
    return timings, errs


# ---------------------------------------------------------------------------
# sequence parallelism: K1 at a query offset, and PPO over a (dp, sp) mesh
# ---------------------------------------------------------------------------

# the sp phase's bf16 depth (full width): at 28 layers its two ranks took
# 60.6 s on an H100 (18 s an update, 16 of them summing 6.2 GB of f32
# gradients through gloo), 61.1 s at 8 and 65.1 s at 4 (the embedding's
# gradient dominates the sum)
SP_LAYERS = 8
SP_F32_LAYERS = 2  # its f32 run (4 before the ppo and algo phases came)
SP_STEPS = 2  # ppo_updates a run
SP_SHARDS = {2: (0, 1024), 4: (0, 512, 1024, 1536)}  # q_start of each shard of T = 2048
# the offset kernels against their plain versions: bf16 within the K1
# limits (K1a's max |out - plain| and K1b/K1c's max |diff| over the largest
# element, the worst of every earlier run); the summed
# dk/dv partials against the unsharded kernel within the bf16 check's 2e-2
# of the largest element (each partial is rounded to bf16 once before the
# sum, where the unsharded kernel rounds once), in f32 within 1e-5
# (K1a's 1.56e-2 is 2^-6 = 0.015625 rounded: one bf16 step at |out| in [2, 4)).
# f32: the forward within 1e-6 (absolute, as every f32 forward so far), the
# gradients within 1e-5 of the largest element (hd 256 sums 256-wide
# products over 8 q heads in another order than the plain version: 1.4e-6
# seen; the unsharded check holds them to 1e-4)
K1A_OFFSET_ATOL, K1BC_OFFSET_RTOL = 2.0 ** -6, 7.6e-3
F32_OFFSET_TOL, F32_OFFSET_GRAD_RTOL = 1e-6, 1e-5
SUM_F32_TOL = 1e-5  # f32 partials summed in another order than one kernel's sum
# sp = 2 against sp = 1 in the sp phase.  bf16: the two runs' products have
# other row counts ([16 x 512] against [16 x 1024] per projection), so cuBLAS
# may round them apart, and that compounds over 28 layers; the flash rows
# are bit-equal.  The same mean logprob bound as trainer against server;
# loss and grad norm within 5e-2 relative.  f32 (SP_F32_LAYERS): 1e-5 on
# logprobs and on the loss (relative), 1e-4 relative on the grad norm.
SP_BF16_STAT_RTOL = 5e-2
SP_F32_LOGP_ATOL, SP_F32_LOSS_RTOL, SP_F32_GRAD_RTOL = 1e-5, 1e-5, 1e-4


def compare_flash_offset(name, qs, k, v, dout, sg, sp, window=None, softcap=None):
    """K1a/b/c at each query offset of `sp` shards of the rows `sg` against
    their plain versions (the K1 limits), each shard's out, lse and dq
    bit-equal to the unsharded kernels' rows (the shards start on a tile
    boundary, so every row walks the same key tiles), the shards' dk/dv
    partials summed against the unsharded dk/dv kernel, the key rows past a
    shard's last query exactly 0 in its partials (written, not left: the
    allocator's free blocks are filled with NaN first), every kernel run
    twice bit-equal and on its variant.  Returns the worst |kernel - plain|
    of each kernel."""
    B, T = sg.shape
    n = T // sp
    f32 = qs.dtype == torch.float32
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    tc0 = [w.launches_tc for w in wrappers]
    full_out, full_lse = fa.flash_fwd(qs, k, v, sg, window, softcap)
    full_di = fa.attention_di(full_out, dout)
    full_dq = fa.flash_bwd_dq(qs, k, v, sg, dout, full_lse, full_di, window, softcap)
    full_dk, full_dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, full_lse, full_di, window, softcap)
    sum_dk, sum_dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(
        v, dtype=torch.float32)
    errs = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0.0)
    ok = True
    for s in range(sp):
        a = s * n
        q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
        kw = dict(q_start=a, kv_segment_ids=sg)
        out, lse = fa.flash_fwd(q_s, k, v, sg_s, window, softcap, **kw)
        out2, lse2 = fa.flash_fwd(q_s, k, v, sg_s, window, softcap, **kw)
        di = full_di[:, :, a:a + n].contiguous()  # the same bits as the unsharded rows
        dq = fa.flash_bwd_dq(q_s, k, v, sg_s, do_s, lse, di, window, softcap, **kw)
        dq2 = fa.flash_bwd_dq(q_s, k, v, sg_s, do_s, lse, di, window, softcap, **kw)
        poison = [torch.full_like(k, float("nan")) for _ in range(4)]
        del poison
        dk, dv = fa.flash_bwd_dkv(q_s, k, v, sg_s, do_s, lse, di, window, softcap, **kw)
        dk2, dv2 = fa.flash_bwd_dkv(q_s, k, v, sg_s, do_s, lse, di, window, softcap, **kw)
        p_out, p_lse = fa.flash_fwd_plain(q_s, k, v, sg_s, window, softcap, **kw)
        p_dq = fa.flash_bwd_dq_plain(q_s, k, v, sg_s, do_s, p_lse, di, window, softcap, **kw)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(q_s, k, v, sg_s, do_s, p_lse, di, window, softcap,
                                            **kw)
        torch.cuda.synchronize()
        valid = sg_s >= 0
        e_out = float((out.float() - p_out.float()).abs()[valid].max())
        rels, abss = [], []
        for x, y in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
            diff = (x.float() - y.float()).abs()
            rels.append(float(diff.max() / y.float().abs().max().clamp_min(1e-30)))
            abss.append(float(diff.max()))
        reruns = (torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
                  and torch.equal(dk, dk2) and torch.equal(dv, dv2))
        rows_equal = (torch.equal(out, full_out[:, a:a + n]) and torch.equal(
            lse, full_lse[:, :, a:a + n]) and torch.equal(dq, full_dq[:, a:a + n]))
        tail_zero = not (dk[:, a + n:].any() or dv[:, a + n:].any())
        finite = all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
        sum_dk += dk.float()
        sum_dv += dv.float()
        errs["flash_fwd"] = max(errs["flash_fwd"], e_out)
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], abss[0])
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], abss[1], abss[2])
        tol_out, tol_grad = ((F32_OFFSET_TOL, F32_OFFSET_GRAD_RTOL) if f32
                             else (K1A_OFFSET_ATOL, K1BC_OFFSET_RTOL))
        good = (e_out <= tol_out and max(rels) <= tol_grad and reruns and rows_equal
                and tail_zero and finite)
        print(f"  {name}, sp {sp} shard {s} (q_start {a}): max|out - plain| {e_out:.3e}; dq, "
              f"dk, dv max|diff|/max {rels[0]:.2e}, {rels[1]:.2e}, {rels[2]:.2e} (tol "
              f"{tol_out:g}, {tol_grad:g}); reruns equal {reruns}; out, lse, dq = the "
              f"unsharded rows {rows_equal}; keys past the shard 0 {tail_zero}")
        ok &= good
    sum_err = [float((x - y.float()).abs().max() / y.float().abs().max())
               for x, y in ((sum_dk, full_dk), (sum_dv, full_dv))]
    sum_tol = SUM_F32_TOL if f32 else BF16_RTOL
    tc_runs = [w.launches_tc - t for w, t in zip(wrappers, tc0)]
    want_tc = [0, 0, 0] if f32 else [1 + 2 * sp] * 3
    print(f"  {name}, sp {sp}: summed dk, dv partials against the unsharded kernel "
          f"max|diff|/max {sum_err[0]:.2e}, {sum_err[1]:.2e} (tol {sum_tol:g}); "
          f"tensor-core launches {tc_runs} (want {want_tc})")
    if not ok or max(sum_err) > sum_tol or tc_runs != want_tc:
        raise AssertionError(f"the offset flash kernels disagree: {name}, sp {sp}")
    return errs


def check_flash_offset():
    """`compare_flash_offset` at Qwen2.5's training heads on T = 2048 (3
    segments and tail padding) at sp 2 and 4, window 256 and softcap 30 at
    sp 2, f32 at T = 256; the same at hd 256 on Gemma-2B's heads.  The
    inputs are `check_flash`'s (same seeds).  Returns the worst bf16
    |kernel - plain| of each kernel."""
    seg2048 = packed_segments(2048, [700, 900, 300])
    seg256 = packed_segments(256, [100, 140])
    cases = []
    for hd, heads in ((128, {}), (256, dict(GEMMA1_HEADS))):
        cases += [
            (200, f"hd {hd}, T=2048, 3 segments + padding", seg2048, dict(heads), (2, 4)),
            (202, f"hd {hd}, T=2048, window 256", seg2048, dict(heads, window=256), (2,)),
            (203, f"hd {hd}, T=2048, softcap 30", seg2048, dict(heads, softcap=30.0), (2,)),
            (204, f"hd {hd} f32, T=256", seg256, dict(heads, dtype=torch.float32), (2,)),
        ]
    worst = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0.0)
    for seed, name, seg, kw, sps in cases:
        dtype = kw.get("dtype", torch.bfloat16)
        qs, k, v, dout, sg = flash_case(seed, seg, dtype=dtype, Hq=kw.get("Hq", 12),
                                        Hkv=kw.get("Hkv", 2), hd=kw.get("hd", 128))
        for sp in sps:
            errs = compare_flash_offset(name, qs, k, v, dout, sg, sp, kw.get("window"),
                                        kw.get("softcap"))
            if dtype != torch.float32:
                worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


def segment_positions(seg: np.ndarray) -> np.ndarray:
    """Each token's position in its (contiguous) segment; -1 on padding."""
    pos = np.full(seg.shape, -1, np.int64)
    for b, row in enumerate(seg):
        start = 0
        for t in range(len(row)):
            if t and row[t] != row[t - 1]:
                start = t
            if row[t] >= 0:
                pos[b, t] = t - start
    return pos


def offset_bounds(qs, k, seg, q_start):
    """Least time of each offset kernel for one shard: its causal share.
    Operations: the (query, key) pairs of the shard's valid queries (each
    sees its segment up to itself) x Hq x hd x 4 / 6 / 8 (forward, dq,
    dk/dv).  Bytes: both segment-id arrays, the shard's valid q (and dout,
    lse, di) rows, the K/V rows its queries see, once each; the outputs
    written once (dk/dv over every key)."""
    B, n, Hq, hd = qs.shape
    T, Hkv = k.shape[1], k.shape[2]
    item = qs.element_size()
    s = seg.cpu().numpy()
    pos = segment_positions(s)[:, q_start:q_start + n]
    valid = pos >= 0
    pairs = int((pos[valid] + 1).sum())
    keys = 0  # the K/V rows the shard's queries see
    for row in s:
        shard = row[q_start:q_start + n]
        for sid in np.unique(shard[shard >= 0]):
            where = np.nonzero(row == sid)[0]
            keys += min(int(where[-1]) + 1, q_start + n) - int(where[0])
    n_valid = int(valid.sum())
    ids = B * (n + T) * 4
    q_in, kv_in, row_in = n_valid * Hq * hd * item, keys * Hkv * hd * item, n_valid * Hq * 4
    q_out, kv_out, row_out = B * n * Hq * hd * item, B * T * Hkv * hd * item, B * Hq * n * 4
    ops = pairs * Hq * hd
    work = {
        "flash_fwd": (ids + q_in + 2 * kv_in + q_out + row_out, 4 * ops),
        "flash_bwd_dq": (ids + 2 * q_in + 2 * kv_in + 2 * row_in + q_out, 6 * ops),
        "flash_bwd_dkv": (ids + 2 * q_in + 2 * kv_in + 2 * row_in + 2 * kv_out, 8 * ops),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[qs.dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out, pairs


def time_flash_offset(seg_rows, sp=2, Hq=12, Hkv=2, hd=128, label=""):
    """Each shard of `sp` over the packed rows `seg_rows` at Qwen2.5's
    training heads in bf16: the offset kernels against their plain
    versions (`compare_flash_offset`), then each shard's kernels, plain
    versions and torch SDPA on the same [Tq, Tk] boolean mask timed (SDPA
    forward for K1a, forward + backward for K1b and K1c), by CUDA events
    and by device time, with the shard's bound.  Returns {shard: timings}
    and the |kernel - plain| of each kernel."""
    seg = torch.from_numpy(np.ascontiguousarray(seg_rows)).to(torch.int32)
    qs, k, v, dout, sg = flash_case(310, seg, Hq=Hq, Hkv=Hkv, hd=hd)
    errs = compare_flash_offset(f"{label} rows {tuple(seg.shape)}", qs, k, v, dout, sg, sp)
    B, T = sg.shape
    n = T // sp
    sdpa = torch.nn.functional.scaled_dot_product_attention
    idx = torch.arange(T, device=sg.device)
    out = {}
    for s in range(sp):
        a = s * n
        q_s, do_s, sg_s = (x[:, a:a + n].contiguous() for x in (qs, dout, sg))
        kw = dict(q_start=a, kv_segment_ids=sg)
        o, lse = fa.flash_fwd(q_s, k, v, sg_s, **kw)
        di = fa.attention_di(o, do_s)
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q_s, k, v, sg_s, **kw),
                          lambda: fa.flash_fwd_plain(q_s, k, v, sg_s, **kw)),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q_s, k, v, sg_s, do_s, lse, di, **kw),
                             lambda: fa.flash_bwd_dq_plain(q_s, k, v, sg_s, do_s, lse, di,
                                                           **kw)),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q_s, k, v, sg_s, do_s, lse, di, **kw),
                              lambda: fa.flash_bwd_dkv_plain(q_s, k, v, sg_s, do_s, lse, di,
                                                             **kw)),
        }
        qi = idx[a:a + n]
        same = (sg_s[:, :, None] == sg[:, None, :]) & (sg_s[:, :, None] >= 0)
        mask = (same & (idx[None, None, :] <= qi[None, :, None])) | (
            idx[None, None, :] == qi[None, :, None])  # pad queries see themselves
        mask = mask[:, None]
        q4 = q_s.transpose(1, 2).detach().requires_grad_(True)
        k4 = k.transpose(1, 2).detach().requires_grad_(True)
        v4 = v.transpose(1, 2).detach().requires_grad_(True)
        g4 = do_s.transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True)

        def lib_fwd_bwd():
            torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True),
                                (q4, k4, v4), g4)

        lib = {"flash_fwd": cuda_ms(lib_fwd, iters=20, warmup=3)}
        lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cuda_ms(lib_fwd_bwd, iters=10, warmup=2)
        lib_dev = (device_ms(lib_fwd, iters=20), device_ms(lib_fwd_bwd, iters=10))
        bounds, pairs = offset_bounds(q_s, k, sg, a)
        shard = {}
        for name, (kernel, plain) in runs.items():
            ms = cuda_ms(kernel, iters=20, warmup=3)
            dev = device_ms(kernel, iters=20)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            shard[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib[name],
                               bound_ms=bounds[name][0], bound_by=bounds[name][1])
            print(f"  {label} shard {s} (q_start {a}) {name}: kernel {ms:.4f} ms (device "
                  f"{fmt_ms(dev)}), plain {plain_ms:.4f} ms, SDPA {lib[name]:.4f} ms, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]})")
        print(f"  {label} shard {s}: {pairs} attended pairs per q head; SDPA device time "
              f"forward {fmt_ms(lib_dev[0])}, forward + backward {fmt_ms(lib_dev[1])}")
        out[s] = shard
    return out, errs


def sp_rows():
    """The sp phase's packed segment ids: the worker's seeded batch in rows
    of 1024, as the engine packs it."""
    from areal_tpu_torch.utils.data import pack_into_rows

    batch = mp_worker.make_batch(qwen25_1p5b().vocab_size, "qwen2.5-1.5b")
    row = mp_worker.BATCH_SHAPES["qwen2.5-1.5b"][4]
    return pack_into_rows(batch, row, rows_bucket_pow2=True).data["segment_ids"]


def fmt_list(xs, spec):
    return "[" + ", ".join(format(x, spec) for x in xs) + "]"


def sp_runs(cases):
    """For each (dtype, layers) of `cases`: sp = 1 in this process; then
    two ranks of the worker sharing the card run every case at sp = 2 (one
    launch), on the same seeded batch and weights.  Checks each case as
    `sp_phase` says and returns [(sp = 1 result, the ranks' results)]."""
    ones = []
    for dtype, layers in cases:
        t0 = time.perf_counter()
        one = mp_worker.run_case("qwen2.5-1.5b", 1, 1, dtype, SP_STEPS, layers=layers)
        print(f"  sp=1 {dtype} at {layers} layers: compute_logp {one['logp_s']:.3f} s, "
              f"ppo_update " + ", ".join(f"{s['ppo_update_s']:.3f}" for s in one["steps"])
              + f" s, train_batch " + ", ".join(fmt_list(s["train_batch_s"], ".3f")
                                                for s in one["steps"])
              + f" s, peak {one['peak_gib']:.2f} GiB ({time.perf_counter() - t0:.1f} s in all)")
        ones.append(one)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mp_worker.collect(mp_worker.launch(2, [
        "--meshes", ",".join(f"1x2:{dtype}:{layers}" for dtype, layers in cases),
        "--steps", str(SP_STEPS)]), timeout=600)
    print(f"  two ranks at sp=2: {time.perf_counter() - t0:.1f} s of wall, startup included")
    n_mb = mp_worker.BATCH_SHAPES["qwen2.5-1.5b"][-1]
    out = []
    for c, (dtype, layers) in enumerate(cases):
        two = [r[c] for r in ranks]
        for r in two:
            print(f"  {dtype} rank {r['proc']} ({r['backend']}, {r['device']}): compute_logp "
                  f"{r['logp_s']:.3f} s ({r['logp_collective_s']:.3f} s in collectives), "
                  + "; ".join(f"update {i}: loss {fmt_list(s['loss'], '+.6f')} grad_norm "
                              f"{fmt_list(s['grad_norm'], '.6f')} ppo_update "
                              f"{s['ppo_update_s']:.3f} s, train_batch "
                              f"{fmt_list(s['train_batch_s'], '.3f')} s, collectives "
                              f"{s['collective_s']:.3f} s" for i, s in enumerate(r["steps"]))
                  + f"; {r['collective_calls']} collectives; peak {r['peak_gib']:.2f} GiB; K1 "
                  f"launches fwd/dq/dkv: logp {r['logp_flash']}, updates "
                  f"{[s['flash'] for s in r['steps']]} (tensor cores "
                  f"{[s['flash_tc'] for s in r['steps']]})")
        for i, (a, b) in enumerate(zip(*[r["steps"] for r in two])):
            if a["params"] != b["params"] or a["loss"] != b["loss"] or a["grad_norm"] != b[
                    "grad_norm"]:
                raise AssertionError(f"the ranks' update {i} differs: {a} against {b}")
        want_logp = [layers, 0, 0]
        want_step = [2 * layers * n_mb, layers * n_mb, layers * n_mb]  # full remat
        for r in two:
            if r["logp_flash"] != want_logp or any(s["flash"] != want_step
                                                   for s in r["steps"]):
                raise AssertionError(f"rank {r['proc']}: K1 launches {r['logp_flash']}, "
                                     f"{[s['flash'] for s in r['steps']]}; want {want_logp}, "
                                     f"{want_step} an update")
            if dtype == "bfloat16" and any(s["flash_tc"] != want_step for s in r["steps"]):
                raise AssertionError(f"rank {r['proc']}: a bf16 K1 launch missed the tensor "
                                     "cores")
        if [r["rollout_calls"] for r in two] != [1, 0] or {r["backend"] for r in two} != {
                "gloo"}:
            raise AssertionError("the head alone must roll out, over gloo")
        print(f"  {dtype}: the ranks' parameters bit-equal after every update: digests "
              f"{[s['params'] for s in two[0]['steps']]}")
        out.append((ones[c], two))
    return out


def sp_compare(one, two, dtype):
    """sp = 2's head against sp = 1: logprobs on the loss-mask tokens, loss
    and grad norm per update, at the dtype's tolerance."""
    lp1, lp2 = mp_worker.decode_logp(one), mp_worker.decode_logp(two[0])
    mask = mp_worker.make_batch(qwen25_1p5b().vocab_size, "qwen2.5-1.5b")["loss_mask"] > 0
    pred = np.roll(mask, -1, axis=-1)  # predictor-aligned: the completion's tokens
    d = np.abs(lp2 - lp1)[pred]
    stats = [(abs(y - x), abs(y - x) / max(abs(x), 1e-12), k, i, x)
             for i, (a, b) in enumerate(zip(one["steps"], two[0]["steps"]))
             for k in ("loss", "grad_norm") for x, y in zip(a[k], b[k])]
    print(f"  {dtype} sp=2 against sp=1: |logprob| max {d.max():.3e}, mean {d.mean():.3e} "
          f"over {d.size} tokens; " + ", ".join(
              f"update {i} {k} |diff| {ab:.3e} ({rel:.2e} relative)"
              for ab, rel, k, i, _ in stats))
    if dtype == "bfloat16":
        bad = d.mean() > LOGP_MEAN_TOL or any(
            ab > SP_BF16_STAT_RTOL * max(abs(x), 1e-2) for ab, _, _, _, x in stats)
    else:
        bad = d.max() > SP_F32_LOGP_ATOL or any(
            rel > (SP_F32_LOSS_RTOL if k == "loss" else SP_F32_GRAD_RTOL)
            for _, rel, k, _, _ in stats)
    if bad or not np.isfinite(lp2).all():
        raise AssertionError(f"{dtype}: sp=2 disagrees with sp=1")
    return float(d.max())


def sp_phase():
    """The sequence-parallel training path at full width: PPOActor at
    sp = 2 as two ranks sharing the card (gloo), against sp = 1, in bf16
    at SP_LAYERS and in f32 at SP_F32_LAYERS; then the offset kernels
    timed on the phase's rows and at T = 2048.  Returns the launches of
    the bf16 and f32 runs' ranks, the timings and the kernels' errors."""
    (one, two), (one32, two32) = sp_runs([("bfloat16", SP_LAYERS),
                                          ("float32", SP_F32_LAYERS)])
    bf16_max = sp_compare(one, two, "bfloat16")
    sp_compare(one32, two32, "float32")

    def launches(rs):
        return [sum(r["logp_flash"][j] + sum(s["flash"][j] for s in r["steps"]) for r in rs)
                for j in range(3)]

    rows = sp_rows()
    times, errs = time_flash_offset(rows, label="sp phase")
    t2048, errs2 = time_flash_offset(packed_segments(2048, [700, 900, 300]).numpy()
                                     .repeat(8, axis=0), label="T=2048 x 8 rows")
    errs = {n: max(errs[n], errs2[n]) for n in errs}
    split = [(s["collective_s"], sum(s["train_batch_s"])) for s in two[0]["steps"]]
    print("  bf16 sp=2 ppo_updates (rank 0): collectives / train_batch calls "
          + ", ".join(f"{c:.3f} / {t:.3f} s" for c, t in split)
          + "; sp=1 train_batch " + ", ".join(fmt_list(s["train_batch_s"], ".3f")
                                              for s in one["steps"])
          + f" s; logprob max |diff| {bf16_max:.3e}")
    return launches(two), launches(two32), times, t2048, errs


# ---------------------------------------------------------------------------
# the algorithms beyond GRPO: PPO with a learned critic, SFT, the reward
# model, AEnt
# ---------------------------------------------------------------------------

PPO_STEPS = 3
PPO_NEW = 128  # new tokens a trajectory
# the critic's values through the flash kernels against naive attention:
# the mean |difference| over the mean |value| (values scale with the head,
# so the limit is relative; bf16 hidden states differ by the K1 rounding)
VALUE_REL_TOL = 5e-2
CLAMP = 0.2  # AEnt's entropy clamp
CLAMP_ATOL = 1e-3  # the kthvalue threshold against a full f32 sort
SFT_ROWS, ALGO_ROW = 16, 1024  # the SFT batch: 16 packed rows of 1024
RW_PAIRS = 15  # odd: the last pair of the last micro-batch is filler


def wait_idle(addr, timeout=60.0):
    """The server's /metrics once its decode steps stop moving (the
    trainer's last in-flight requests finished)."""
    from areal_tpu_torch.scripts import bench_e2e_grpo as bench

    deadline = time.monotonic() + timeout
    last = bench.server_metrics(addr)
    while time.monotonic() < deadline:
        time.sleep(0.5)
        m = bench.server_metrics(addr)
        if m["decode_steps"] == last["decode_steps"]:
            return m
        last = m
    raise AssertionError(f"the server at {addr} did not go idle in {timeout} s")


def ppo_phase(ckpt_dir):
    """PPO with a learned critic through the port's example
    (`examples/math/gsm8k_ppo.py`, `gsm8k_grpo.run` with a `PPOConfig`) at
    full width from the SPEC_PPO_LAYERS checkpoint: actor and critic (f32
    masters, bf16 compute, full remat, the yaml's minibatches) in this
    process, one server process on the card (32 slots, max_seq_len 1024,
    the launch helper), 8 prompts x group 4, PPO_NEW new tokens, PPO_STEPS
    asynchronous steps (the first finds nothing in flight: its rollouts are
    a sync step's), transfer publishes (no snapshot on disk), the parity
    reward.  Checks the trainer-against-server logprob gap on same-version
    tokens, values finite and nonzero after step 1, exact flash launches a
    step (the actor's and the critic's), all on the tensor cores, the
    server's K2 = layers x decode steps; then the critic's values through
    the flash kernels against naive attention on the last batch, and a
    forced critic save (bf16 backbone, f32 `value_head.npy`) reloaded into
    a fresh critic: values bit-equal to the live critic's on its masters
    rounded to bf16.  Returns (K2 launches, flash launches)."""
    from areal_tpu_torch.api.config import GenServerConfig
    from areal_tpu_torch.engine.ppo import TorchPPOActor, TorchPPOCritic
    from areal_tpu_torch.examples.math import gsm8k_grpo, gsm8k_ppo
    from areal_tpu_torch.launcher.local import LocalLauncher
    from areal_tpu_torch.scripts import bench_e2e_grpo as bench
    from areal_tpu_torch.utils.saver import Saver

    fileroot = os.path.join(ROOT, "build", "ppo_run")
    shutil.rmtree(fileroot, ignore_errors=True)
    config, _ = gsm8k_ppo.parse_args([
        f"cluster.fileroot={fileroot}", f"total_train_steps={PPO_STEPS}",
        "async_training=true", "weight_update_mode=transfer", f"actor.path={ckpt_dir}",
        "actor.init_from_scratch=false", f"gconfig.max_new_tokens={PPO_NEW}",
        f"gconfig.n_samples={GROUP}", f"actor.group_size={GROUP}",
        f"train_dataset.batch_size={TRAIN_PROMPTS}",
        f"rollout.consumer_batch_size={TRAIN_PROMPTS}"])
    launcher = LocalLauncher(os.path.join(ROOT, "build", "ppo_logs"))
    steps, gaps = [], []
    compute_advantages = TorchPPOActor.compute_advantages

    def spy_advantages(actor, batch):
        # the batch before the advantages rewrite it: the recompute against
        # the behaviour logprobs on tokens of the trainer's version
        gaps.append(bench.same_version_logp_gap(batch, actor.get_version()))
        compute_advantages(actor, batch)

    def on_step(step, actor, batch, line):
        steps.append(dict(counts=np.array(flash_counts()), values=batch["values"],
                          mask=batch["loss_mask"] > 0, line=line))
        if step == PPO_STEPS - 1:  # the forced critic save of the last step
            steps[-1]["batch"] = {k: batch[k] for k in ("input_ids", "attention_mask")}
            steps[-1]["saved"] = Saver(config.saver).save(
                actor.critic, 0, step, step, name="critic", force=True)
            steps[-1]["critic"] = actor.critic

    t0 = time.perf_counter()
    old_addrs = os.environ.get("AREAL_LLM_SERVER_ADDRS")
    try:
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=ckpt_dir, dtype="bfloat16", max_seqs=GRPO_SLOTS,
            max_context_len=GRPO_SEQ, page_size=128, random_seed=0))[0]
        print(f"  server process up at {addr} in {time.perf_counter() - t0:.1f} s")
        os.environ["AREAL_LLM_SERVER_ADDRS"] = addr
        m0 = bench.server_metrics(addr)
        V = TransformerConfig.from_hf(ckpt_dir).vocab_size
        dataset = bench.make_dataset(256, V, GRPO_PROMPT_LEN[1], GRPO_PROMPT_LEN[0])
        reset_flash_counts()
        TorchPPOActor.compute_advantages = spy_advantages
        t0 = time.perf_counter()
        try:
            stats = gsm8k_grpo.run(config, reward_fn=bench._reward_last_even, dataset=dataset,
                                   on_step=on_step)
        finally:
            TorchPPOActor.compute_advantages = compute_advantages
        wall = time.perf_counter() - t0
        m1 = wait_idle(addr)
    finally:
        launcher.stop_all()
        if old_addrs is None:
            os.environ.pop("AREAL_LLM_SERVER_ADDRS", None)
        else:
            os.environ["AREAL_LLM_SERVER_ADDRS"] = old_addrs
    critic = steps[-1]["critic"]
    acfg, ccfg = config.actor, config.critic
    L = critic.model_config.num_layers
    ragged = m1["ragged_kernel_launches"] - m0["ragged_kernel_launches"]
    decode = m1["decode_steps"] - m0["decode_steps"]
    print(f"  {PPO_STEPS} steps in {wall:.1f} s (engines' start included); server: ragged "
          f"{ragged} = {L} x {decode} decode steps")
    if ragged != L * decode or decode == 0:
        raise AssertionError("ppo: the server's ragged launches != layers x decode steps")
    # a step: the actor's recompute and the critic's values (one forward
    # each), then every train micro-batch of both (full remat: the forward
    # twice, dq and dk/dv once)
    mbs = (acfg.ppo_n_minibatches * acfg.mb_spec.n_mbs
           + ccfg.ppo_n_minibatches * ccfg.mb_spec.n_mbs)
    want = np.array([L * (2 + 2 * mbs), L * mbs, L * mbs])
    prev = np.zeros(3, np.int64)
    for i, (st, (gap_sum, gap_n)) in enumerate(zip(steps, gaps)):
        got = st["counts"] - prev
        prev = st["counts"]
        v = st["values"][st["mask"]]
        line = st["line"]
        print(f"  step {i}: reward {line['reward']:.3f}, actor losses "
              + ", ".join(f"{x:+.5f}" for x in line["loss"]) + "; critic losses "
              + ", ".join(f"{x:.6f}" for x in line["critic_loss"])
              + f"; |trainer - server| logprob mean {gap_sum / max(gap_n, 1):.4f} over "
              f"{gap_n} same-version tokens; values mean |v| {np.abs(v).mean():.3e}, max "
              f"{np.abs(v).max():.3e}; flash fwd/dq/dkv {tuple(int(x) for x in got)} (want "
              f"{tuple(int(x) for x in want)}); timing "
              + ", ".join(f"{k} {t:.3f}" for k, t in line["timing_s"].items()) + " s")
        if tuple(got) != tuple(want):
            raise AssertionError(f"ppo step {i}: a forward or an update missed the flash "
                                 "kernels")
        if not (np.isfinite(v).all() and np.isfinite(line["loss"]).all()
                and np.isfinite(line["critic_loss"]).all()):
            raise AssertionError(f"ppo step {i}: a non-finite value or loss")
        if i >= 1 and not np.abs(v).max() > 0:
            raise AssertionError(f"ppo step {i}: the critic's values are still 0")
    # over the phase: an async step's batch can come from the previous
    # version alone
    gap_sum, gap_n = np.sum(gaps, axis=0)
    print(f"  |trainer - server| logprob over the phase: mean {gap_sum / max(gap_n, 1):.4f} "
          f"over {int(gap_n)} same-version tokens (tolerance on the mean {LOGP_MEAN_TOL})")
    if gap_n == 0 or not gap_sum / gap_n <= LOGP_MEAN_TOL:
        raise AssertionError("ppo: trainer logprobs disagree with the server's")
    if flash_counts_tc() != flash_counts():
        raise AssertionError("a bf16 flash launch of the ppo phase missed its tensor-core kernel")
    flash = flash_counts()
    # the critic's values through the kernels against naive attention
    batch = steps[-1]["batch"]
    valid = batch["attention_mask"].astype(bool)
    values = critic.compute_values(batch)
    cfg = critic.model.cfg
    critic.model.cfg = cfg.replace(attn_impl="naive")
    try:
        naive = critic.compute_values(batch)
    finally:
        critic.model.cfg = cfg
    diff = np.abs(values - naive)[valid]
    rel = diff.mean() / np.abs(naive[valid]).mean()
    print(f"  critic values, flash against naive attention on the last batch: mean |diff| "
          f"{diff.mean():.3e} over mean |value| {np.abs(naive[valid]).mean():.3e} ({rel:.2e}, "
          f"tolerance {VALUE_REL_TOL}), max |diff| {diff.max():.3e}")
    if not rel <= VALUE_REL_TOL:
        raise AssertionError("ppo: the critic's values through the flash kernels disagree with "
                             "naive attention")
    # the forced save, reloaded: values bit-equal to the live critic's on
    # its masters rounded to bf16 (the checkpoint's backbone dtype)
    saved = steps[-1]["saved"]
    fresh = TorchPPOCritic(dataclasses.replace(ccfg, path=saved, init_from_scratch=False,
                                               optimizer=None))
    fresh.initialize()
    reloaded = fresh.compute_values(batch)
    del fresh
    with torch.no_grad():
        for name, p in critic.model.named_parameters():
            if name != "value_head":  # value_head.npy keeps the f32 master
                p.copy_(p.to(torch.bfloat16))
    live = critic.compute_values(batch)
    size = sum(os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
    print(f"  critic saved to {os.path.relpath(saved, ROOT)} ({size / 1e9:.2f} GB, "
          f"value_head.npy {os.path.exists(os.path.join(saved, 'value_head.npy'))}), reloaded: "
          f"values bit-equal to the live critic's on bf16-rounded masters: "
          f"{np.array_equal(reloaded, live)}")
    if not np.array_equal(reloaded, live):
        raise AssertionError("ppo: the saved critic does not reload to the same values")
    shutil.rmtree(fileroot, ignore_errors=True)
    del critic, steps, stats
    gc.collect()
    torch.cuda.empty_cache()
    return int(ragged), tuple(int(x) for x in flash)


def clamped_entropy_by_sort(logits, clamp):
    """AEnt's clamped entropy with the threshold from a full descending
    sort of each row (what JAX's `top_k` computes), f32."""
    V = logits.shape[-1]
    keep = max(1, V - int(V * clamp))
    kth = logits.sort(dim=-1, descending=True).values[..., keep - 1:keep]
    mask = logits >= kth
    clamped = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    p = torch.softmax(clamped, dim=-1)
    return torch.logsumexp(clamped, dim=-1) - torch.where(mask, p * logits, 0.0).sum(dim=-1)


def check_filler_rows(name, seg):
    """K1a/b/c at Qwen2.5's heads on the reward model's rows `seg` (one
    sequence a row, rows that are filler end to end; `time_flash` holds
    them against the plain versions): each filler row's out 0, lse -inf and
    dq, dk, dv exactly 0 on the kernels and on the plain versions."""
    qs, k, v, dout, sg = flash_case(400, seg)
    filler = ~(sg >= 0).any(dim=-1)
    out, lse = fa.flash_fwd(qs, k, v, sg)
    di = fa.attention_di(out, dout)
    dq = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di)
    p_out, p_lse = fa.flash_fwd_plain(qs, k, v, sg)
    p_dq = fa.flash_bwd_dq_plain(qs, k, v, sg, dout, p_lse, di)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, p_lse, di)
    ok = all(not t[filler].any() for t in (out, dq, dk, dv, p_out, p_dq, p_dk, p_dv))
    ok = ok and bool((lse[filler] == -torch.inf).all() and (p_lse[filler] == -torch.inf).all())
    print(f"  {int(filler.sum())} filler rows: out 0, lse -inf, dq = dk = dv = 0 on the "
          f"kernels and the plain versions: {ok}")
    if not int(filler.sum()) or not ok:
        raise AssertionError(f"{name}: the filler rows' K1 outputs or gradients are not 0")


def time_clamp(hidden, head, clamp):
    """The clamped entropy's forward and forward + backward ms (events) on
    one token chunk's f32 logits, and the same for the plain entropy."""
    logits = (hidden @ head).float().detach()

    def run(fn, backward):
        x = logits.requires_grad_(backward)
        e = fn(x)
        if backward:
            e.sum().backward()
            x.grad = None

    from areal_tpu_torch.ops.functional import _clamped_entropy

    def plain(x):
        return torch.logsumexp(x, -1) - (torch.softmax(x, -1) * x).sum(-1)

    def clamped(x):
        return _clamped_entropy(x, clamp)

    return {name: (cuda_ms(lambda: run(fn, False), iters=10, warmup=2),
                   cuda_ms(lambda: run(fn, True), iters=10, warmup=2))
            for name, fn in (("clamped", clamped), ("plain", plain))}


def algo_phase():
    """The SFT, reward-model, AEnt and critic engines at Qwen2.5-1.5B's full
    width and 28 layers, one at a time from one seeded init (f32 masters,
    bf16 compute, full remat, the example yamls' optimizers), in process,
    no disk writes.  SFT: the loss on the flash path against naive
    attention, then 3 `train_lm` steps on 16 packed rows of 1024 of
    gsm8k-synth solutions (loss on the solution span), tokens/s and MFU.
    RW: 3 `train_rw` steps on RW_PAIRS (odd) preference pairs, one sequence
    a row of 1024 (the last pair of a micro-batch filler); K1 on those rows
    checked with their filler rows and timed.  AEnt: one update with the
    entropy clamp at the full vocab, the clamped entropy against an f32
    full sort, the clamp's time.  Critic: one `ppo_update` with a seeded
    nonzero head, its last layer's dq and dk/dv inputs replayed through the
    kernels and the plain versions.  Returns (flash launches, the RW rows'
    timings, the worst bf16 |kernel - plain|)."""
    from areal_tpu_torch.api import config as tc
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer, generate_problems
    from areal_tpu_torch.engine.ppo import TorchPPOCritic
    from areal_tpu_torch.engine.rw import TorchRewardModelEngine
    from areal_tpu_torch.engine.sft import TorchLMEngine
    from areal_tpu_torch.examples.math.gsm8k_ppo import default_config as ppo_config
    from areal_tpu_torch.examples.rw.hhrlhf_rw import collate as rw_collate
    from areal_tpu_torch.examples.rw.hhrlhf_rw import default_config as rw_config
    from areal_tpu_torch.examples.rw.hhrlhf_rw import synth_pairs
    from areal_tpu_torch.examples.sft.gsm8k_sft import collate as sft_collate
    from areal_tpu_torch.examples.sft.gsm8k_sft import default_config as sft_config
    from areal_tpu_torch.models.transformer import forward_lm
    from areal_tpu_torch.ops.functional import _clamped_entropy
    from areal_tpu_torch.recipes import AEntConfig, AEntPPOActorConfig, TorchAEntPPOActor

    mc = qwen25_1p5b()
    L = mc.num_layers
    tok = WordTokenizer()
    spec = FinetuneSpec(1, 1024, 8)
    rows = dict(pack_length_quantum=ALGO_ROW, max_pack_length=ALGO_ROW)
    reset_flash_counts()
    counted = np.zeros(3, np.int64)  # the path's launches, comparisons left out
    errs = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0.0)

    def make(cls, cfg):
        t0 = time.perf_counter()
        eng = cls(cfg, model_config=mc)
        eng.initialize(ft_spec=spec)
        torch.cuda.synchronize()
        print(f"  {cls.__name__} up in {time.perf_counter() - t0:.1f} s "
              f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
        return eng

    def done(eng):
        eng.destroy()
        gc.collect()
        torch.cuda.empty_cache()

    def step_line(what, st):
        tps = st["tokens"] / st["step_time"]
        return (f"  {what}: loss {st['loss']:.5f} grad_norm {st['grad_norm']:.4f} "
                f"train_batch {st['step_time']:.3f} s, {tps:.1f} tokens/s, mfu "
                f"{st.get('mfu', float('nan')):.4f}")

    # --- SFT
    eng = make(TorchLMEngine, dataclasses.replace(sft_config().model, **rows))
    problems = generate_problems(4096, seed=1)
    samples, total = [], 0
    for item in problems:  # rows of 9..16 sequences' worth pack into 16 rows
        n = len(tok.apply_chat_template(item["messages"])) + len(tok.encode(
            " " + item["solution"])) + 1
        if total + n > (SFT_ROWS - 1) * ALGO_ROW:
            break
        samples.append(item)
        total += n
    batch = sft_collate(samples, tok)
    n_rows = eng._prepare_rows(eng._predictor_align(batch), eng.config.mb_spec.n_mbs)[1][
        "input_ids"].shape[0]
    ev = eng.evaluate_lm(batch)
    cfg = eng.model.cfg
    eng.model.cfg = cfg.replace(attn_impl="naive")
    try:
        ev_naive = eng.evaluate_lm(batch)
    finally:
        eng.model.cfg = cfg
    print(f"  SFT batch: {len(samples)} gsm8k-synth solutions, {total} tokens in {n_rows} rows of "
          f"{ALGO_ROW}; eval loss flash {ev['loss']:.5f}, naive {ev_naive['loss']:.5f} "
          f"(|diff| {abs(ev['loss'] - ev_naive['loss']):.2e}, tolerance {LOGP_MEAN_TOL}), ppl "
          f"{ev['ppl']:.1f}")
    if n_rows != SFT_ROWS or not abs(ev["loss"] - ev_naive["loss"]) <= LOGP_MEAN_TOL:
        raise AssertionError("algo SFT: the flash path's loss disagrees with naive attention, "
                             "or the batch did not pack into 16 rows")
    before = np.array(flash_counts())
    for i in range(3):
        st = eng.train_lm(batch)
        st["tokens"] = total
        print(step_line(f"SFT step {i}", st) + f", ppl {st['ppl']:.1f}, token_acc "
              f"{st['token_acc']:.4f}")
        if not (np.isfinite(st["loss"]) and np.isfinite(st["ppl"])):
            raise AssertionError("algo SFT: a non-finite loss or ppl")
    counted += np.array(flash_counts()) - before
    done(eng)

    # --- RW
    eng = make(TorchRewardModelEngine, dataclasses.replace(rw_config().model, **rows))
    pairs = synth_pairs(RW_PAIRS, 1, tok)
    batch = rw_collate(pairs)
    _, data, _ = eng._prepare_rows(batch, eng.config.mb_spec.n_mbs)
    seg = data["segment_ids"]
    per = seg.shape[0] // eng.config.mb_spec.n_mbs
    print(f"  RW batch: {RW_PAIRS} pairs in {seg.shape[0]} rows of {seg.shape[1]} "
          f"({int((seg >= 0).sum())} tokens, {int((~(seg >= 0).any(-1)).sum())} filler rows)")
    before = np.array(flash_counts())
    for i in range(3):
        st = eng.train_rw(batch)
        st["tokens"] = int((seg >= 0).sum())
        print(step_line(f"RW step {i}", st) + f", acc {st['acc']:.3f}, margin "
              f"{st['margin']:.4f} over {st['n_pairs']:.0f} pairs")
        if not (np.isfinite(st["loss"]) and np.isfinite(st["acc"])):
            raise AssertionError("algo RW: a non-finite loss or accuracy")
    counted += np.array(flash_counts()) - before
    done(eng)
    rw_rows = seg[per:]  # the second micro-batch: its last pair is filler
    rw_times, rw_err = time_flash(rw_rows)
    check_filler_rows(f"RW rows {rw_rows.shape}", torch.from_numpy(rw_rows))
    errs = {n: max(errs[n], rw_err[n]) for n in errs}

    # --- AEnt
    base = ppo_config().actor
    acfg = AEntPPOActorConfig(**{f.name: getattr(base, f.name)
                                 for f in dataclasses.fields(base)}, aent=AEntConfig(
                                     entropy_clamp=CLAMP))
    acfg = dataclasses.replace(acfg, **rows)
    eng = make(TorchAEntPPOActor, acfg)
    rng = np.random.default_rng(31)
    B, P, N = TRAIN_PROMPTS * GROUP, 128, 384
    ids = rng.integers(0, mc.vocab_size, (B, P + N)).astype(np.int32)
    lm = np.zeros((B, P + N), np.float32)
    lm[:, P:] = 1.0
    rl_batch = {"input_ids": ids, "attention_mask": np.ones((B, P + N), bool), "loss_mask": lm,
                "logprobs": rng.normal(-12.0, 0.5, (B, P + N)).astype(np.float32) * lm,
                "rewards": rng.integers(0, 2, B).astype(np.float32)}
    ab = dict(rl_batch)
    before = np.array(flash_counts())
    ab["prox_logp"] = eng.compute_logp(ab)
    eng.compute_advantages(ab)
    t0 = time.perf_counter()
    ast = eng.ppo_update(ab)
    torch.cuda.synchronize()
    upd = time.perf_counter() - t0
    counted += np.array(flash_counts()) - before
    for i, st in enumerate(ast):
        st["tokens"] = int(ab["attention_mask"].sum()) // len(ast)
        print(step_line(f"AEnt update, minibatch {i}", st) + f", clamped entropy "
              f"{st['entropy']:.4f}, coefficient {st['entropy_coeff']:.3e}")
    # the clamp on one chunk of the update's real logits
    _, data, _ = eng._prepare_rows(ab, 1)
    mb = eng._to_device({k: data[k][:2] for k in ("input_ids", "positions", "segment_ids")})
    with torch.no_grad():
        out = forward_lm(eng.model, mb["input_ids"], mb["positions"], mb["segment_ids"])
        hidden = out.hidden.reshape(-1, out.hidden.shape[-1])[:ALGO_ROW]
        logits = (hidden @ out.head).float()
        got, want = _clamped_entropy(logits, CLAMP), clamped_entropy_by_sort(logits, CLAMP)
        full = _clamped_entropy(logits, 0.0)
    ent_err = (got - want).abs().max().item()
    t = time_clamp(hidden, out.head, CLAMP)
    n_chunks = -(-int(data["input_ids"].size) // ALGO_ROW)
    # a chunk's entropy runs in the forward, then again in the checkpointed
    # recompute with its backward: forward + (forward + backward)
    extra = n_chunks * (sum(t["clamped"]) - sum(t["plain"]))
    print(f"  AEnt clamp {CLAMP} at vocab {mc.vocab_size} on {ALGO_ROW} tokens: kthvalue "
          f"against a full f32 sort max |diff| {ent_err:.2e} (tolerance {CLAMP_ATOL}); clamped "
          f"entropy mean {got.mean().item():.4f} against the plain {full.mean().item():.4f}; a "
          f"chunk's clamped entropy {t['clamped'][0]:.2f} ms forward, {t['clamped'][1]:.2f} ms "
          f"forward + backward (plain {t['plain'][0]:.2f}, {t['plain'][1]:.2f} ms); "
          f"{n_chunks} chunks an update: the clamp adds about {extra / 1e3:.3f} s to the "
          f"update's {upd:.3f} s")
    if not ent_err <= CLAMP_ATOL or not all(np.isfinite(st["loss"]) for st in ast):
        raise AssertionError("algo AEnt: the clamped entropy disagrees with the full sort")
    del out, hidden, logits, mb
    done(eng)

    # --- critic
    eng = make(TorchPPOCritic, dataclasses.replace(ppo_config().critic, **rows))
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        D = mc.hidden_size
        eng.model.value_head.copy_(torch.randn(D, generator=g, device="cuda") / D ** 0.5)
    cb = {k: rl_batch[k] for k in ("input_ids", "attention_mask")}
    cb["loss_mask"] = np.roll(rl_batch["loss_mask"], -1, axis=-1)
    cb["loss_mask"][:, -1] = 0
    cb["returns"] = rng.standard_normal(cb["loss_mask"].shape).astype(np.float32) * cb["loss_mask"]
    before = np.array(flash_counts())
    cb["values"] = eng.compute_values(cb)
    seen = []
    check = fa._check

    def record(qs, k, v, segment_ids, *extra, **kw):
        if len(extra) == 3 and not seen:  # the first backward call: the last layer
            seen.append(tuple(t.detach() for t in (qs, k, v, segment_ids, *extra)))
        return check(qs, k, v, segment_ids, *extra, **kw)

    fa._check = record
    try:
        cst = eng.ppo_update(cb)
    finally:
        fa._check = check
    counted += np.array(flash_counts()) - before
    for i, st in enumerate(cst):
        st["tokens"] = int(cb["attention_mask"].sum()) // len(cst)
        print(step_line(f"critic minibatch {i}", st) + f", value_clip_ratio "
              f"{st['value_clip_ratio']:.0f} of {st['n_valid_tokens']:.0f}")
    qs, k, v, sg, dout, lse, di = seen[0]
    dq = fa.flash_bwd_dq(qs, k, v, sg, dout, lse, di)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, sg, dout, lse, di)
    p_dq = fa.flash_bwd_dq_plain(qs, k, v, sg, dout, lse, di)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(qs, k, v, sg, dout, lse, di)
    rels = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in ((dq, p_dq), (dk, p_dk), (dv, p_dv))]
    print(f"  critic update, the last layer's backward inputs {tuple(qs.shape)} (max |dout| "
          f"{dout.abs().max().item():.3e}): dq, dk, dv max|diff|/max against the plain "
          f"versions {rels[0]:.2e}, {rels[1]:.2e}, {rels[2]:.2e} (tol {BF16_RTOL})")
    if not dout.abs().max().item() > 0 or max(rels) > BF16_RTOL or not all(
            np.isfinite(st["loss"]) for st in cst):
        raise AssertionError("algo critic: K1b or K1c disagrees with its plain version on the "
                             "critic's update, or no gradient reached the backbone")
    errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], float((dq - p_dq).abs().max()))
    errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], float((dk - p_dk).abs().max()),
                                float((dv - p_dv).abs().max()))
    del seen, qs, k, v, sg, dout, lse, di, dq, dk, dv, p_dq, p_dk, p_dv
    done(eng)
    print(f"  launches over the path: flash fwd/dq/dkv {tuple(int(x) for x in counted)} "
          f"({L} layers)")
    if flash_counts_tc() != flash_counts():
        raise AssertionError("a bf16 flash launch of the algo phase missed its tensor-core "
                             "kernel")
    return tuple(int(x) for x in counted), rw_times, errs


# ---------------------------------------------------------------------------
# the tiers phase: length-cohort tiers, migration, the host tier and the
# staged weights, in process at 28 layers
# ---------------------------------------------------------------------------

TIER_SLOTS, TIER_SEQ = 16, 2048  # decode_tiers=2: ceilings (1024, 2048), (8, 8) slots
TIER_HOST_MB = 2048  # the host tier: 16 spilled prefixes of up to 2048 tokens fit


def _tier_requests(vocab, seed=7):
    """16 greedy requests, in the order admission places them: 8 long-tier
    blockers (900..950-token prompts, 128 new tokens: budgets above 1024),
    4 movers (760..800, 256 new) that find the long tier full and start in
    the short one, which they outgrow after the blockers have left, and 4
    short ones (700..900, 64 new)."""
    rng = np.random.default_rng(seed)
    plan = [("blocker", 900, 951, 128)] * 8 + [("mover", 760, 801, 256)] * 4 + \
        [("short", 700, 901, 64)] * 4
    return [GenRequest(rid=f"{kind}{i}", input_ids=rng.integers(
                0, vocab, int(rng.integers(lo, hi))).tolist(), max_new_tokens=new,
                min_new_tokens=new, temperature=0.0)
            for i, (kind, lo, hi, new) in enumerate(plan)]


def _drive(eng, reqs):
    """Submit `reqs` and step the engine until they finish: (engine steps'
    K2 launches, decode steps, verify calls, wall seconds, the first engine
    step's seconds: admission, the prefills and one chunk)."""
    launches0 = ragged_paged_attention.launches
    steps0, verifies0 = eng.stats["decode_steps"], eng.stats["verify_calls"]
    t0 = time.perf_counter()
    first = None
    for r in reqs:
        eng.submit(r)
    while any(not r.stop_reason for r in reqs):
        eng.step()
        if first is None:
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
    torch.cuda.synchronize()
    return (ragged_paged_attention.launches - launches0, eng.stats["decode_steps"] - steps0,
            eng.stats["verify_calls"] - verifies0, time.perf_counter() - t0, first)


def tiers_phase(ckpt_dir):
    """The serve phase's model (28 layers, bf16) in two engines of 16 slots x
    2048: tiered (decode_tiers=2, the host tier on) and untiered.  Tiers: the
    same 16 greedy requests through both (after a warm-up batch of the
    same shapes; untiered first, both walls printed), token streams equal,
    migrations > 0, K2 = 28 x (decode steps + verify calls) on the tiered
    run.  Host
    tier: 16 filler prompts overwrite every tiered slot (16 spills), then a
    mover's transcript comes back: it swaps in, its row's bytes equal the
    spilled bytes, and its greedy continuation equals the untiered
    engine's, whose prefix never left the device; spill and swap-in of a
    1024-token block timed.  Staged weights: `stage_params` from host
    tensors on a thread while the engine decodes, `commit_staged` live and
    aborting, each advancing the version, their pauses against
    `load_weights` of the same host tensors.  Returns the phase's K2
    launches."""
    from areal_tpu_torch.models.hf import load_hf_params

    launches0 = ragged_paged_attention.launches
    t0 = time.perf_counter()
    model, cfg = load_hf_params(ckpt_dir, qwen25_1p5b(), "cuda")
    L = cfg.num_layers
    kw = dict(n_slots=TIER_SLOTS, max_seq_len=TIER_SEQ, prompt_bucket=128, kv_dtype="bfloat16",
              seed=0)
    tiered = GenEngine(cfg, params=model, decode_tiers=2, host_offload=True,
                       host_cache_mb=TIER_HOST_MB, **kw)
    untiered = GenEngine(cfg, params=model, **kw)
    if (tiered.tier_bounds, tiered.tier_size) != ([1024, 2048], [8, 8]):
        raise AssertionError(f"tiers phase: layout {tiered.tier_bounds} {tiered.tier_size}")
    print(f"  {L} layers loaded, two engines in {time.perf_counter() - t0:.1f} s")

    # --- tiers and migration ---
    # the first run at these shapes in a process is slower whichever
    # engine takes it: a batch of the same shapes (other tokens) through
    # the untiered engine first, so the two timed runs are both warm
    _drive(untiered, _tier_requests(cfg.vocab_size, seed=5))
    t_reqs, u_reqs = _tier_requests(cfg.vocab_size), _tier_requests(cfg.vocab_size)
    _, u_steps, _, u_wall, u_first = _drive(untiered, u_reqs)
    launches, steps, verifies, wall, first = _drive(tiered, t_reqs)
    occupancy_seen = tiered.stats["tier_migrations"]
    tokens = sum(len(r.output_tokens) for r in t_reqs)
    print(f"  {tokens} tokens a run; untiered {u_wall:.4f} s ({u_steps} decode steps; the first "
          f"engine step {u_first:.4f} s, the rest {u_wall - u_first:.4f} s), then tiered "
          f"{wall:.4f} s ({steps} decode steps, {verifies} verify calls; the first engine step "
          f"{first:.4f} s, the rest {wall - first:.4f} s), {occupancy_seen} migrations; K2 "
          f"launches {launches} = {L} x {steps + verifies}: {launches == L * (steps + verifies)}")
    for a, b in zip(t_reqs, u_reqs):
        if a.output_tokens != b.output_tokens or len(a.output_tokens) != a.max_new_tokens:
            raise AssertionError(f"tiers phase: {a.rid}'s tiered stream differs from the "
                                 "untiered engine's")
    if occupancy_seen == 0:
        raise AssertionError("tiers phase: no request migrated")
    if launches != L * (steps + verifies):
        raise AssertionError("tiers phase: K2 launches are not layers x (steps + verifies)")
    tiered.pool.check_page_table()
    print(f"  tiered and untiered greedy streams equal, all {len(t_reqs)} requests; page table "
          "a permutation")

    # --- the host tier ---
    rng = np.random.default_rng(8)
    fillers = [GenRequest(rid=f"fill{i}", input_ids=rng.integers(0, cfg.vocab_size, 200).tolist(),
                          max_new_tokens=8, temperature=0.0) for i in range(TIER_SLOTS)]
    swaps0 = tiered.stats["prefix_cache_host_swaps"]
    _drive(tiered, fillers)
    spills = tiered.stats["prefix_cache_host_swaps"] - swaps0
    if spills != TIER_SLOTS:
        raise AssertionError(f"tiers phase: {spills} spills, want {TIER_SLOTS}")
    mover = next(r for r in t_reqs if r.rid.startswith("mover"))
    again = mover.input_ids + mover.output_tokens
    (hid, lcp), = ((h, n) for h, n in tiered.pool.match_host(again).items() if n > 1000)
    ent = tiered.pool.host_entry(hid)
    spilled = {k: v.clone() for k, v in ent.kv.items()}
    resub = [GenRequest(rid="again", input_ids=list(again), max_new_tokens=32,
                        min_new_tokens=32, temperature=0.0) for _ in range(2)]
    tiered.submit(resub[0])
    tiered._admit()
    slot = next(s for s in range(TIER_SLOTS) if tiered.slot_req[s] is resub[0])
    row = tiered.pool.row(slot)
    equal = all(torch.equal(tiered.cache[k][:, row, :ent.valid_len].cpu(),
                            v[:, :ent.valid_len]) for k, v in spilled.items())
    while not resub[0].stop_reason:
        tiered.step()
    _drive(untiered, resub[1:])
    print(f"  {spills} spills of retained prefixes; the mover's transcript ({len(again)} tokens) "
          f"swapped back in: {ent.valid_len} positions, row bytes equal the spilled bytes: "
          f"{equal}; cache hit {resub[0].cache_hit_tokens} (untiered, never left the device: "
          f"{resub[1].cache_hit_tokens}); continuations equal: "
          f"{resub[0].output_tokens == resub[1].output_tokens}")
    if not equal:
        raise AssertionError("tiers phase: a swapped-in row differs from its spilled bytes")
    if (resub[0].output_tokens != resub[1].output_tokens
            or resub[0].cache_hit_tokens != ent.valid_len):
        raise AssertionError("tiers phase: the swapped-in continuation differs from the "
                             "device-resident one")
    # spill and swap-in of a 1024-token block, through the pinned buffer,
    # on the scratch row
    block, nbytes = 1024, None
    spill_s, swap_s = [], []
    for _ in range(5):
        t1 = time.perf_counter()
        kv = tiered._host_gather(TIER_SLOTS, block)
        t2 = time.perf_counter()
        tiered._host_scatter(kv, TIER_SLOTS)
        t3 = time.perf_counter()
        spill_s.append(t2 - t1)
        swap_s.append(t3 - t2)
        nbytes = sum(v.numel() * v.element_size() for v in kv.values())
    sp, sw = float(np.median(spill_s)), float(np.median(swap_s))
    print(f"  a {block}-token block ({nbytes / 1e6:.1f} MB, {nbytes // block} B a token): spill "
          f"{sp * 1e3:.2f} ms ({nbytes / sp / 1e9:.1f} GB/s), swap-in {sw * 1e3:.2f} ms "
          f"({nbytes / sw / 1e9:.1f} GB/s); median of 5, the pinned staging buffer")

    # --- the staged weights ---
    t1 = time.perf_counter()
    host = {n: p.detach().cpu() for n, p in model.state_dict().items()}
    print(f"  the weights copied to host memory in {time.perf_counter() - t1:.2f} s "
          f"({sum(v.numel() * v.element_size() for v in host.values()) / 1e9:.2f} GB)")
    # budgets that outlast both stagings: the commits land mid-stream
    reqs = [GenRequest(rid=f"st{i}", input_ids=rng.integers(0, cfg.vocab_size, 128).tolist(),
                       max_new_tokens=1536, min_new_tokens=1536, temperature=0.0)
            for i in range(TIER_SLOTS)]
    for r in reqs:
        tiered.submit(r)
    tiered.step()
    box = {}

    def stage(version):
        t = time.perf_counter()
        box["ok"] = tiered.stage_params(host, version)
        box["s"] = time.perf_counter() - t

    th = threading.Thread(target=stage, args=(1,))
    th.start()
    during = steps_during = 0
    while th.is_alive():
        during += tiered.step()
        steps_during += 1
    th.join()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    v_live = tiered.commit_staged(live=True)
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t1
    tiered.step()
    stage(2)
    t1 = time.perf_counter()
    v_abort = tiered.commit_staged(live=False)
    torch.cuda.synchronize()
    abort_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    v_load = tiered.load_weights(model=tiered.place_params(host), version=3)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    versions = sorted({v for r in reqs for v in r.output_versions})
    print(f"  stage_params on a thread while decoding: {box['ok']} in {box['s']:.2f} s, "
          f"{during} tokens in {steps_during} engine steps decoded meanwhile "
          f"({during / box['s']:.0f} tokens/s); commit_staged(live=True) -> v{v_live} in "
          f"{live_s * 1e3:.2f} ms, commit_staged(live=False) -> v{v_abort} in "
          f"{abort_s * 1e3:.2f} ms (aborting {sum(r.stop_reason == 'abort' for r in reqs)}); "
          f"load_weights of the same host tensors -> v{v_load} in {load_s * 1e3:.1f} ms; the "
          f"requests' token versions {versions}")
    if not (box["ok"] and (v_live, v_abort, v_load) == (1, 2, 3) and versions == [0, 1]):
        raise AssertionError("tiers phase: the staged commits did not advance the version")
    if not all(r.stop_reason == "abort" for r in reqs):
        raise AssertionError("tiers phase: the aborting commit left a request running")
    del tiered, untiered, model, host
    gc.collect()
    torch.cuda.empty_cache()
    return ragged_paged_attention.launches - launches0


# ---------------------------------------------------------------------------
# the disagg phase: a prefill and a decode server behind the router
# ---------------------------------------------------------------------------

DISAGG_SLOTS, DISAGG_NEW = 8, 64


def _spawn(cmd, log_path):
    log_f = open(log_path, "ab")
    return subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, stdout=log_f,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _await(cond, what, timeout=180.0):
    t0 = time.perf_counter()
    while True:
        try:
            if cond():
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"disagg phase: {what} within {timeout:.0f} s")
        time.sleep(0.2)


def disagg_phase(ckpt_dir, build_dir):
    """`python -m areal_tpu_torch.gen.server --role prefill` and `--role
    decode` (8 slots x 2048 each, the router phase's checkpoint of
    REMOTE_LAYERS layers) behind `python -m areal_tpu_torch.gen.router
    --disagg`.  8 requests of 256..900-token prompts and 64 new tokens, half
    greedy and half sampled, each with a pinned stream, one after another
    through the router (so that each server's calls have the shapes the
    control's have).  Checks: 8 handoffs and 0 fallbacks (router
    /metrics), the decode server's 8 imports swapped in and its K2 =
    layers x its decode steps, then, the prefill server's retained
    prefixes overwritten by a batch of fillers, each merged stream (tokens
    and logprobs) equal to the same two-leg split served by the prefill
    server alone.  Returns the K2 launches of both server processes."""
    from areal_tpu_torch.api.config import GenServerConfig
    from areal_tpu_torch.launcher.local import build_server_cmd
    from areal_tpu_torch.utils.network import find_free_ports
    from areal_tpu_torch.utils.telemetry import parse_prometheus_text

    log_dir = os.path.join(build_dir, "disagg_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    os.makedirs(log_dir)
    cfg = GenServerConfig(model_path=ckpt_dir, dtype="bfloat16", max_seqs=DISAGG_SLOTS,
                          max_context_len=2048, page_size=128, random_seed=0)
    ports = find_free_ports(3)
    addrs = [f"127.0.0.1:{p}" for p in ports[:2]]
    raddr = f"127.0.0.1:{ports[2]}"
    procs = []
    try:
        t0 = time.perf_counter()
        for port, role in zip(ports[:2], ("prefill", "decode")):
            procs.append(_spawn(build_server_cmd(cfg, port) + [f"--role={role}"],
                                os.path.join(log_dir, f"{role}.log")))
        for a in addrs:
            _await(lambda a=a: get_addr(a, "/health", timeout=2)["status"] == "ok",
                   f"server {a} up")
        procs.append(_spawn([sys.executable, "-m", "areal_tpu_torch.gen.router",
                             f"--addrs={','.join(addrs)}", "--disagg", "--host=127.0.0.1",
                             f"--port={ports[2]}", "--exit-with-parent"],
                            os.path.join(log_dir, "router.log")))
        _await(lambda: get_addr(raddr, "/metrics", timeout=2)["roles"] == dict(
            zip(addrs, ("prefill", "decode"))), "the router and its roles")
        print(f"  prefill and decode servers and the router up in "
              f"{time.perf_counter() - t0:.1f} s; roles {get_addr(raddr, '/metrics')['roles']}")
        vocab = qwen25_1p5b().vocab_size
        rng = np.random.default_rng(9)
        bodies = []
        for i in range(8):
            greedy = i % 2 == 0
            sp = dict(max_new_tokens=DISAGG_NEW, min_new_tokens=DISAGG_NEW,
                      temperature=0.0 if greedy else 1.0, top_p=1.0 if greedy else 0.9)
            bodies.append(dict(rid=f"dg{i}", stream_id=1000 + i, sampling_params=sp,
                               input_ids=rng.integers(0, vocab, int(rng.integers(256, 901))
                                                      ).tolist()))
        t0 = time.perf_counter()
        merged = [post_addr(raddr, "/generate", b) for b in bodies]
        wall = time.perf_counter() - t0
        rm = get_addr(raddr, "/metrics")
        pre, dec = (get_addr(a, "/metrics") for a in addrs)
        prom = {a: parse_prometheus_text(urllib.request.urlopen(
            f"http://{a}/metrics?format=prometheus", timeout=60).read().decode()) for a in addrs}
        L = REMOTE_LAYERS
        nh = max(1, rm["handoffs"])
        svc = {op: prom[a]["areal_gen_kv_handoff_seconds_sum"][f'{{op="{op}"}}']
               / prom[a]["areal_gen_kv_handoff_seconds_count"][f'{{op="{op}"}}']
               for a, op in zip(addrs, ("export", "import"))}
        print(f"  8 requests in {wall:.2f} s through the router: handoffs {rm['handoffs']}, "
              f"fallbacks {rm['handoff_fallbacks']}; {rm['handoff_bytes'] / nh / 1e6:.2f} MB a "
              f"handoff, export + import {rm['handoff_seconds'] / nh * 1e3:.1f} ms through the "
              f"router ({rm['handoff_bytes'] / max(rm['handoff_seconds'], 1e-9) / 1e6:.1f} MB/s "
              f"of K/V over the JSON wire); the workers' service: export "
              f"{svc['export'] * 1e3:.2f} ms, import {svc['import'] * 1e3:.2f} ms")
        print(f"  prefill server: exports {pre['kv_handoff_exports']}, decode steps "
              f"{pre['decode_steps']}; decode server: imports {dec['kv_handoff_imports']}, host "
              f"swaps {dec['prefix_cache_host_swaps']}, K2 {dec['ragged_kernel_launches']} = "
              f"{L} x {dec['decode_steps']} decode steps")
        if (rm["handoffs"], rm["handoff_fallbacks"]) != (8, 0):
            raise AssertionError("disagg phase: want 8 handoffs and 0 fallbacks")
        if not all(r.get("handoff") is True and len(r["output_tokens"]) == DISAGG_NEW
                   for r in merged):
            raise AssertionError("disagg phase: a merged stream is short or was not handed off")
        if dec["kv_handoff_imports"] != 8 or dec["prefix_cache_host_swaps"] < 8:
            raise AssertionError("disagg phase: the decode server did not swap in every import")
        if dec["decode_steps"] == 0 or dec["ragged_kernel_launches"] != L * dec["decode_steps"]:
            raise AssertionError("disagg phase: the decode server's K2 launches are not layers x "
                                 "its decode steps")
        # the control: the prefill server's retained prefixes overwritten (one
        # batch of fillers takes every slot), then the same two legs on it
        post_addr(addrs[0], "/generate_batch", {"requests": [
            dict(rid=f"fill{i}", input_ids=rng.integers(0, vocab, 64).tolist(),
                 sampling_params=dict(max_new_tokens=1)) for i in range(DISAGG_SLOTS)]})
        same = 0
        for b, got in zip(bodies, merged):
            sp = b["sampling_params"]
            leg1 = post_addr(addrs[0], "/generate", dict(b, sampling_params=dict(
                sp, max_new_tokens=1, min_new_tokens=1)))
            leg2 = post_addr(addrs[0], "/generate", dict(
                b, input_ids=b["input_ids"] + leg1["output_tokens"],
                sampling_params=dict(sp, max_new_tokens=DISAGG_NEW - 1,
                                     min_new_tokens=DISAGG_NEW - 1)))
            want_t = leg1["output_tokens"] + leg2["output_tokens"]
            want_l = leg1["output_logprobs"] + leg2["output_logprobs"]
            same += (got["output_tokens"], got["output_logprobs"]) == (want_t, want_l)
        pre2 = get_addr(addrs[0], "/metrics")
        print(f"  against the two-leg split on the prefill server alone: {same} of 8 merged "
              f"streams equal, tokens and logprobs (its K2 {pre2['ragged_kernel_launches']} = "
              f"{L} x {pre2['decode_steps']})")
        if same != 8:
            raise AssertionError("disagg phase: a merged stream differs from the single-server "
                                 "two-leg split")
        if pre2["ragged_kernel_launches"] != L * pre2["decode_steps"]:
            raise AssertionError("disagg phase: the prefill server's K2 launches are not layers "
                                 "x its decode steps")
        return dec["ragged_kernel_launches"] + pre2["ragged_kernel_launches"]
    finally:
        for p in procs[::-1]:
            p.terminate()
        for p in procs[::-1]:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main(argv):
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    with phase("device"):
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        print(f"  nvidia-smi: {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
              f"{torch.cuda.device_count()} device(s)")
    with phase("build"):
        logs = _build.build(["ragged_decode", "flash_attention"])
        for name, log in logs.items():
            print(f"  {name}.cu:\n" + "\n".join("    " + ln for ln in log.strip().splitlines()))
        if not logs:
            print("  already built")
    if only == "recover":
        # the recover phase alone, on sequence lengths of the grpo rows' shape
        lens = [int(m.sum()) for m in recover_batch(5, 8)["attention_mask"]]
        with phase("recover"):
            recover_phase(os.path.join(ROOT, "build"), lens)
    elif only == "gemma1":
        g1_dir = os.path.join(ROOT, "build", "gemma1_ckpt")
        g1_publish = os.path.join(ROOT, "build", "gemma1_publish")
        try:
            with phase("gemma1"):
                gemma1_timings(gemma1_phase(g1_dir, g1_publish)[-1])
        finally:
            for d in (g1_dir, g1_publish):
                shutil.rmtree(d, ignore_errors=True)
    elif only == "spec":
        # the spec phase alone, on a checkpoint written as the whole script writes it
        ckpt_dir = os.path.join(ROOT, "build", "spec_ppo_ckpt")
        try:
            write_checkpoint(qwen25_1p5b().replace(num_layers=SPEC_PPO_LAYERS).to_hf_dict(),
                             ckpt_dir)
            with phase("spec"):
                spec_phase(ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    elif only == "kernels":
        with phase("kernels"):
            check_kernel()
            check_verify_kernel()
            check_flash()
            check_flash_offset()
        with phase("kernel timings"):
            for name in DECODE_SHAPES[:-1]:
                print_k2(*decode_case_timed(name))
            spec_timings()
            gemma1_timings(gemma1_like_rows())
            dkv_cluster_sweep()
    elif only == "sp":
        with phase("kernels (offset variant)"):
            check_flash_offset()
        with phase("sp"):
            sp_phase()
    elif only in ("router", "ppo"):
        # the phase alone, on a checkpoint written as the whole script writes it
        layers = REMOTE_LAYERS if only == "router" else SPEC_PPO_LAYERS
        ckpt_dir = os.path.join(ROOT, "build", f"{only}_ckpt")
        try:
            write_checkpoint(qwen25_1p5b().replace(num_layers=layers).to_hf_dict(), ckpt_dir)
            with phase(only):
                if only == "router":
                    router_qwen(ckpt_dir, os.path.join(ROOT, "build"))
                else:
                    ppo_phase(ckpt_dir)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    elif only == "algo":
        with phase("algo"):
            algo_phase()
    elif only in ("tiers", "disagg"):
        # the phase alone, on a checkpoint written as the whole script writes
        # it: the serve phase's 28 layers, the router phase's REMOTE_LAYERS
        layers = SERVE_LAYERS if only == "tiers" else REMOTE_LAYERS
        ckpt_dir = os.path.join(ROOT, "build", f"{only}_ckpt")
        try:
            write_checkpoint(qwen25_1p5b().replace(num_layers=layers).to_hf_dict(), ckpt_dir)
            with phase(only):
                if only == "tiers":
                    tiers_phase(ckpt_dir)
                else:
                    disagg_phase(ckpt_dir, os.path.join(ROOT, "build"))
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    elif only == "recover-full-depth":
        fileroot = os.path.join(ROOT, "build", "recover_run")
        try:
            with phase("recover at 28 layers"):
                recover_run(fileroot, SERVE_LAYERS)
        finally:
            shutil.rmtree(fileroot, ignore_errors=True)
    if only is not None:
        print(f"card: {smi}")
        return 0
    with phase("kernels"):
        max_err = check_kernel()
        flash_checks = check_flash()
        flash_err, flash_err256 = flash_checks[128], flash_checks[256]
        offset_err = check_flash_offset()
    with phase("engine"):
        check_engine()
    build_dir = os.path.join(ROOT, "build")
    ckpt_dir = os.path.join(build_dir, "smoke_ckpt")
    publish_dir = os.path.join(build_dir, "smoke_publish")
    remote_dir = os.path.join(build_dir, "remote_publish")
    gemma_dir = os.path.join(build_dir, "gemma2_ckpt")
    gemma_publish = os.path.join(build_dir, "gemma2_publish")
    qwen3_dir = os.path.join(build_dir, "qwen3_ckpt")
    gemma1_dir = os.path.join(build_dir, "gemma1_ckpt")
    gemma1_publish = os.path.join(build_dir, "gemma1_publish")
    remote_ckpt = os.path.join(build_dir, "remote_ckpt")
    spec_ppo_ckpt = os.path.join(build_dir, "spec_ppo_ckpt")
    scratch = (ckpt_dir, publish_dir, remote_dir, gemma_dir, gemma_publish, qwen3_dir,
               gemma1_dir, gemma1_publish, remote_ckpt, spec_ppo_ckpt)
    for d in scratch:
        shutil.rmtree(d, ignore_errors=True)
    try:
        with phase("serve"):
            engine, launches, steps, wall, tokens = serve_qwen(ckpt_dir)
        with phase("timings"):
            tok_s = decode_rate(engine)
            dev_step = profile_decode(engine)
            if dev_step is not None:
                wall_step = 1e3 * engine.n_slots / tok_s
                print(f"  decode step: {wall_step:.2f} ms of wall (unprofiled rate), "
                      f"{dev_step:.3f} ms of device time: device busy "
                      f"{100 * dev_step / wall_step:.1f}%")
            del engine
            label, main_t = decode_case_timed("serving")
            print_k2(label, main_t)
            kern, plain, sdpa, bound, by = main_t[:5]
            print_k2(*decode_case_timed("full window"))
            print(f"  decode {tok_s:.1f} tokens/s (16 slots, 512-token prompts, greedy); "
                  f"serve window {tokens / wall:.1f} tokens/s incl. prefill")
            torch.cuda.empty_cache()
        with phase("spec"):
            write_checkpoint(qwen25_1p5b().replace(num_layers=SPEC_PPO_LAYERS).to_hf_dict(),
                             spec_ppo_ckpt)
            spec_err, verify_launches, spec_decode_launches, spec_f32_launches, verify_times = (
                spec_phase(spec_ppo_ckpt))
            max_err = max(max_err, spec_err)
        with phase("tiers"):
            tiers_launches = tiers_phase(ckpt_dir)
        with phase("train"):
            flash_launches, train_stats, seg_rows = train_qwen(ckpt_dir, publish_dir)
            on_tc = flash_counts_tc()
            print(f"  flash launches over the phase fwd/dq/dkv {flash_launches}; "
                  f"on the tensor cores {on_tc}")
            if on_tc != flash_launches:
                raise AssertionError("a bf16 flash launch of the train phase missed its "
                                     "tensor-core kernel")
        with phase("flash timings"):
            flash_times, train_err = time_flash(seg_rows)
            flash_err = {n: max(flash_err[n], train_err[n]) for n in flash_err}
        with phase("sp"):
            sp_bf16, sp_f32, sp_times, sp_t2048, sp_err = sp_phase()
            offset_err = {n: max(offset_err[n], sp_err[n]) for n in offset_err}
        with phase("grpo"):
            write_checkpoint(qwen25_1p5b().replace(num_layers=REMOTE_LAYERS).to_hf_dict(),
                             remote_ckpt)
            grpo_launches, grpo_err, _, grpo_rows = grpo_loop(remote_ckpt)
            max_err = max(max_err, grpo_err["ragged_paged_attention"])
            flash_err = {n: max(flash_err[n], grpo_err[n]) for n in flash_err}
        with phase("prefix"):
            prefix_launches = prefix_qwen()
        with phase("families"):
            gemma_ragged, _, _ = gemma_serve_and_train(gemma_dir, gemma_publish)
            shutil.rmtree(gemma_dir, ignore_errors=True)
            write_checkpoint(dict(QWEN3_1P7B, num_hidden_layers=QWEN3_LOOP_LAYERS), qwen3_dir)
            qwen3_launches, qwen3_err, _, qwen3_rows = grpo_loop(qwen3_dir, "qwen3-1.7b",
                                                                 FAMILY_PLANS)
            timing_err = families_timings(qwen3_rows)
            max_err = max(max_err, qwen3_err["ragged_paged_attention"])
            flash_err = {n: max(flash_err[n], qwen3_err[n], timing_err[n]) for n in flash_err}
            family_launches = (gemma_ragged + qwen3_launches[0], *qwen3_launches[1:])
            shutil.rmtree(qwen3_dir, ignore_errors=True)
        with phase("gemma1"):
            gemma1_ragged, gemma1_flash, ladder_flash, _, gemma1_rows = gemma1_phase(
                gemma1_dir, gemma1_publish)
            for d in (gemma1_dir, gemma1_publish):
                shutil.rmtree(d, ignore_errors=True)
            flash_times256, gemma1_err = gemma1_timings(gemma1_rows)
            flash_err256 = {n: max(flash_err256[n], gemma1_err[n]) for n in flash_err256}
        with phase("remote"):
            remote_ragged, remote_flash = remote_qwen(remote_ckpt, remote_dir)
        with phase("router"):
            router_ragged, router_flash = router_qwen(remote_ckpt, build_dir)
        with phase("disagg"):
            disagg_launches = disagg_phase(remote_ckpt, build_dir)
            shutil.rmtree(remote_ckpt, ignore_errors=True)
        with phase("ppo"):
            ppo_ragged, ppo_flash = ppo_phase(spec_ppo_ckpt)
        with phase("algo"):
            algo_flash, rw_times, algo_err = algo_phase()
            flash_err = {n: max(flash_err[n], algo_err[n]) for n in flash_err}
        with phase("recover"):
            recover_ragged, recover_flash = recover_phase(build_dir,
                                                          segment_lengths(grpo_rows))
    finally:
        for d in scratch:
            shutil.rmtree(d, ignore_errors=True)
    records = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "areal_tpu/ops/ragged_decode.py:93",
        "launches": (launches + grpo_launches[0] + prefix_launches + family_launches[0]
                     + gemma1_ragged + remote_ragged + router_ragged + ppo_ragged
                     + recover_ragged + verify_launches + spec_decode_launches
                     + spec_f32_launches + tiers_launches + disagg_launches),
        # "spec": the launches at T = D + 1 the --spec-decode server
        # counted; "spec_decode": both spec-phase servers' T = 1 launches;
        # "spec_f32": the in-process f32 runs at 4 layers; "tiers": every
        # engine run of that phase; "disagg": both of its server processes
        "launches_by_path": {"serve": launches, "grpo": grpo_launches[0],
                             "prefix": prefix_launches, "families": family_launches[0],
                             "gemma1": gemma1_ragged, "remote": remote_ragged,
                             "router": router_ragged, "ppo": ppo_ragged,
                             "recover": recover_ragged, "spec": verify_launches,
                             "spec_decode": spec_decode_launches,
                             "spec_f32": spec_f32_launches, "tiers": tiers_launches,
                             "disagg": disagg_launches},
        # the verify half at the spec servers' shape, T = 4 and 8
        "verify": {f"T{T}": dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                     verify_times[T][:5])) for T in verify_times},
        "max_abs_err": max_err,
        "ms": kern,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": sdpa,
    }, {
        # its variant for bf16 calls of at most 16 rows a kv head, which
        # took every decode launch of the serve phase (counted there); the
        # times are the serving shape's, as above
        "name": "ragged_paged_attention_dec",
        "route": "cuda",
        "source": "areal_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "areal_tpu/ops/ragged_decode.py:93",
        "launches": launches,
        "launches_by_path": {"serve": launches},
        "max_abs_err": max_err,
        "ms": kern,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": sdpa,
    }]
    for name, n, n_grpo, n_fam, n_remote, n_router, n_ppo, n_algo, n_recover in zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_launches, grpo_launches[1:],
            family_launches[1:], remote_flash, router_flash, ppo_flash, algo_flash,
            recover_flash):
        ms, plain_ms, lib_ms, bound_ms, bound_by = flash_times[name]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": (n + n_grpo + n_fam + n_remote + n_router + n_ppo + n_algo
                         + n_recover),
            "launches_by_path": {"train": n, "grpo": n_grpo, "families": n_fam,
                                 "remote": n_remote, "router": n_router, "ppo": n_ppo,
                                 "algo": n_algo, "recover": n_recover},
            # the reward model's rows: one sequence a row of 1024, filler rows
            "rw_rows": dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                rw_times[name])),
            "max_abs_err": flash_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    # the same kernels' hd-256 variants (wg::flash_wg_kernel<false>, the
    # forward, and <true>, dq; tc::flash_bwd_dkv_tc256_kernel), run by
    # the gemma1 path only
    for name, n, n_ladder in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), gemma1_flash,
                                 ladder_flash):
        ms, plain_ms, lib_ms, bound_ms, bound_by = flash_times256[name]
        records.append({
            "name": f"{name}_hd256",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": n + n_ladder,
            "launches_by_path": {"gemma1": n, "gemma1_rung_ladder": n_ladder},
            "max_abs_err": flash_err256[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    # the offset variant of the same kernels (q_start > 0 under sp), run by
    # the sp phase's two ranks; its times are shard 1's (q_start 512, the
    # larger causal share) on that phase's rows
    for n_bf16, n_f32, name in zip(sp_bf16, sp_f32, ("flash_fwd", "flash_bwd_dq",
                                                      "flash_bwd_dkv")):
        t = sp_times[1][name]
        records.append({
            "name": f"{name}_sp",
            "route": "cuda",
            "source": "areal_tpu_torch/csrc/flash_attention.cu",
            "replaces": "areal_tpu/ops/attention.py:386 (_sharded_splash: "
                        + FLASH_REPLACES[name].split("(", 1)[1],
            "launches": n_bf16 + n_f32,
            "launches_by_path": {"sp_bf16": n_bf16, "sp_f32": n_f32},
            "shards": {"sp_rows": sp_times, "T2048": sp_t2048},
            "max_abs_err": offset_err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"card: {smi}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s of wall")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
