#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. device   — require CUDA, print the card's name and power limit, turn TF32
              off for every comparison (fp32 products stay full fp32);
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (one ``nvcc`` per source, all at once); print each kernel's
              registers and spill bytes (``-Xptxas -v``) and the tensor-core
              instructions (``cuobjdump -sass``) of the bf16 GEMMs (wgmma
              fed by TMA: HGMMA and UTMALDG; flash's mma.sync tiles: HMMA)
              and the fp64 and complex128 DMMA GEMMs (the fp64 grouped
              collapse among them), which must have them and spill nothing;
3. small    — each kernel against its plain PyTorch version on awkward
              shapes, fp32/fp64, linear/Born, every scaling mode; the
              threefry uniforms on the card equal the CPU's bit for bit;
              the clamped walk (``core/clamped.py``, kernel 3 a site)
              against its plain walk at N = 1 and odd N, χ off the tiles,
              d = 3, a scalar and a per-sample clamp;
   stream   — (after a one-rank NCCL group and 1×1 mesh are made) jiuzhang2
              at full width with the depth cut to M = 24, drawn site by
              site on the card into a bf16 ``GammaStore`` under ``build/``
              (19.2 GB on disk, 76.8 GB decoded: more than the card holds;
              the free disk is checked first); its read path on the card
              (pinned reads, the copy stream, the upcast) equal bit for bit
              to the sites drawn again and rounded, at χ = 10⁴, 4096 and
              256; then streamed: (a) the seq
              walk at N = 1024 through ``SamplingSession(store,
              backend="streamed")`` with a ``device_budget`` that plans
              two sites a segment — 24 ``site_step_linear`` launches, at
              most two live segments, peak memory within two decoded
              segments, their bf16 copies, env and 2 GB — and the same walk
              with the plain cells (samples equal, env and log_scale within
              TOL); (b) dyn-χ (the area-law profile at jiuzhang2's 1.62
              photons in buckets 256/1024/4096/10⁴, Table 1 printed)
              against the same stage loop in memory on the truncated chain,
              each site cut to its stage's χ before it goes to the card,
              run with the kernels and with the plain cells in lockstep
              (kernel 1 held per stage at χ = 256, 1024, 4096 and 10⁴);
              (c) (a) stopped after 3 segments and resumed, bit for bit;
              (d) dp, tp_single ± measure_first and tp_double streamed on
              the mesh over the first 4 sites against their in-memory
              walks, with each kernel's launches; (f) clamped seq and dp
              walks streamed over those 4 sites against the in-memory
              clamped walk (``contract_measure`` × 4); (e) one timed walk at
              N₁ = ``min_macro_batch_for_overlap`` at the measured read
              rate, capped at 65,536: wall, read, H2D and compute seconds,
              GB/s and the overlap share beside ``explain_plan``'s
              prediction; then phase service's streamed parts (c, d) on
              the first 2 of those sites (below); the phase frees its
              memory before phase 4;
   shard    — (inside phase stream, on its 4-site sub-store, a site a
              segment and a block, N = 1024) the sharded plane: (a)
              ``shard="auto"`` through the session on
              ``emulated_cluster(2)`` and ``(4)``: every process == the
              local walk bit for bit, each reads only its own sites (the
              store's bytes and segments), the handoffs those of
              ``ShardMap.handoffs`` and their bytes ``shard_wire_bytes``'s
              plus each payload's ``log_scale``, key and site,
              ``site_step_linear`` × 4 in all; (b) stream (f)'s clamp on
              ``emulated_cluster(2)``: samples and ``log_prob`` == the
              clamped streamed walk, ``contract_measure`` × 4; (c) on the 2
              gloo processes of phase service (d): a pipelined 2-batch
              sharded job on a one-lane service == the local walks, each
              rank reading its 2 sites a batch, × 4 launches a rank; the
              wall, read, handoff (copy, send, wait) and compute seconds,
              the handoff GB/s and the peak memory; (d) rank 0 on its
              ``materialize_shard`` slice with a rotted copy of an owned
              site: the pre-walk round writes it again from rank 1's copy
              (repaired 1 / 0) and the samples == (a)'s; then a rotted
              site no peer holds fails both ranks with
              ``kind="corruption"``;
   gateway  — (inside phase stream, on the first 2 sites) an in-process
              ``Gateway`` over a one-lane ``SamplingService`` on the card,
              2 tenants and a disk ``ResultCache``: a 2-batch job's frames
              == the session's walks of the same batches (× 4 launches);
              the same request a hit (byte-identical, no execution, no
              launch); an identical request attaches; 429 with
              Retry-After over a quota; 404 for another tenant's job; the
              owner's DELETE of a running job streams the error frame;
              ``/metrics``;
4. linear   — the GBS preset ``jiuzhang2`` at its full width (χ=10⁴, d=4,
              fp64) with the depth cut to M=8 sites (the in-memory slice
              holds the whole chain on the card), N=1024, walked through
              ``SamplingSession(kernels="cuda")`` and through the plain
              version; samples equal, log_scale allclose, launches = M;
              one step's kernels by device time (torch.profiler: the
              grouped collapse GEMM ``collapse_f64_kernel`` listed), its
              rate and the card's clock and power under it and cuBLAS;
5. tp       — a one-rank NCCL process group (a ``FileStore`` under
              ``build/``) and a 1×1 mesh; on phase 4's chain, the session
              walks dp, tp_single, tp_single with measure_first and
              tp_double with ``kernels="cuda"``, each checked against the
              same walk with the plain cells (samples equal, env and
              log_scale allclose) and for its launches (M per kernel);
   clamp    — conditional sampling on phase 4's chain: (a) the clamp
              {1: 0, 4: 1, 6: 0} and (b) a per-sample clamp on site 5
              through the session with the kernels (``contract_measure``
              × M, the fused step never), each in lockstep with the plain
              cells (samples equal; env, dlog and dlog_prob within TOL),
              the clamp enforced and every draw it does not force equal to
              the unclamped walk's; (c) ``clamp={}`` is the unclamped walk
              bit for bit; (d) dp, tp_single ± measure_first and tp_double
              on the mesh (the dp walk) equal the seq clamped walk on the
              shard key ``split(key, 1)[0]`` bit for bit; (f) the clamped
              and unclamped walks' wall times with the card's name and
              power limit; (e), after phase 8, a Born clamped walk on its
              chain the same way;
   service  — the job service, fleet workers and the broadcast plane (the
              counts set to 0 just before each walk and read just after):
              (a) ``session.sample`` through the session's one-lane
              ``SamplingService`` on phase 4's chain == the direct core
              walk (``site_step_linear`` × 8), and the wall time the
              service adds; (b) a 4-batch job (N = 1024 a batch) on 1 and
              2 thread lanes == ``sample(N, fold_in(key, b))`` per block
              (× 32 launches), a lane removed mid-job, a clamped 2-batch
              job (``contract_measure`` × 8 a batch, ``log_prob`` == the
              clamped session walk's); (c) on the first 2 sites of phase
              stream's store (bf16, fp64 walked, a site a segment): 2 fleet
              worker processes on the card (``WorkerPool``), 4 batches ==
              the in-process streamed job bit for bit after a dropped
              result (the worker killed, respawned, the batch requeued),
              each batch's 2 launches reported by its worker; the
              ``remote`` runtime's persistent worker, the same payload
              cold and warm; (d) the broadcast plane on
              ``emulated_cluster(2)`` (batch 1's key, then an unclean stop
              at different boundaries and a resume of the last segment)
              and on 2 ``torch.distributed`` processes sharing the card
              over gloo (spawned, a ``FileStore`` under ``build/``): a
              pipelined 2-batch job on a one-lane service whose batch 1
              resumes from the same stop; every block == the in-process
              job's: broadcast bytes, GB/s, the root's read GB/s, each
              process's fetch and compute seconds and overlap share;
              (e) the metrics registry's counters over (b) and (c);
6. tp kernels — contract_measure, measure_probs and collapse_select called
              at the bond-shard shapes of p₂ = 4 (N = 1024), against their
              plain versions, with times and bounds (measure_probs, fp64
              and bf16, by its kernel's device time from torch.profiler:
              CUDA events around a call this short time the host's launch),
              and the card's SM clock, power and temperature while
              contract_measure runs;
7. bf16     — phase 4's chain cast to fp32 (``mxu_bf16``) and to bf16 Γ
              with fp32 Λ (``store_bf16``), walked through the session with
              ``compute_dtype=bf16`` (``site_step_linear``'s bf16 entry
              launched M times each), then lockstep with the plain walk;
              tp_single (± measure_first) and tp_double in mxu_bf16 on the
              mesh, the same way; the four bf16 kernels against their
              plain versions at the walk's and the p₂ = 4 shard shapes in
              both tiers, with times, bounds, TFLOP/s and ``torch.matmul``
              on the bf16 operands as the library yardstick; the site
              step's, contract_measure's and collapse_select's kernels by
              device time (the W and planes pass or the planes pass, the
              bucket sort, the bf16 copies, the wgmma GEMM apart) with the
              card's clock and power under them;
8. born     — χ=10⁴, d=4, complex128, M=4, N=512, the same checks as 4,
              with the site step's TFLOP/s beside cuBLAS's and the card's
              SM clock and power while each runs; then a Born tp_double
              walk on the mesh against the dp walk;
9. displacement — ``ops.displacement_matrices`` (the main path of the
              displacement kernel: its complex entry, one kernel and no
              other) on B = 2²⁰ μ's with |μ| ≤ 1.5 and μ = 0, d ∈ {4
              (jiuzhang2's cutoff), 16}, complex128 and complex64, against
              the plain version by ``displacement_expm.check_rounding``
              and the planes entry's bits; the planes entry's and the main
              path's times by CUDA events and by device time
              (torch.profiler), and the bound; then the kernel and its
              plain version on 2¹⁶ draws at d = 16 in each of the four
              |μ| ranges where the sums reach subnormal numbers, the
              check's counts and the most subnormal spacings printed;
10. flash   — the flash-attention kernel against its plain version at the
              granite-3-2b shapes (B = 2, S = T = 4096, H = 32, KVH = 8,
              Dh = 64, bf16, causal), non-causal, Dh = 128 with KVH = H,
              MQA, and fp32 at S = 1024; kimi-k2-1t-a32b's prefill (H =
              64, KVH = 8, Dh = 112) in bf16 and in fp32 at S = 1024;
              times, the bound,
              ``F.scaled_dot_product_attention`` as the library yardstick,
              and the card's clock, power and temperature while it runs;
11. lm      — granite-3-2b at full width (40 layers, bf16, weights from the
              port's seeded init on the card): ``make_prefill_step`` at
              B = 2, S = 4096 through the flash kernel (40 launches), its
              last-token logits against the same prefill with the plain
              attention; decode (plain ``_sdpa``) against the forward on a
              short sequence; ``serve()`` of 16 requests (batch 8, 16 new
              tokens, cache 64), cold and again warm; one decode step's
              wall time against its device time (torch.profiler); peak
              memory and wall times;
    moe     — (after lm, which frees granite) deepseek-v3-671b (MLA, 256 +
              1 experts, top-8) with 2 of its 61 layers and kimi-k2-1t-a32b
              (GQA 64/8 at head_dim 112, 384 + 1 experts) with 1, at their
              published widths, bf16 weights from the port's seeded init on
              the card (49.7 and 38.8 GB): a prefill at B = 2 (S = 2048 and
              4096; capacity 80 and 112) with each layer's drop_frac and
              lb_loss, kimi-k2's through ``flash_attention`` once (Dh =
              112) and against the same prefill with the plain attention;
              decode against the forward on S = 16 at capacity_factor =
              n_experts / top_k (at the published 1.25 a 16-token row gets
              capacity 1 and the forward drops tokens a one-token decode
              step never drops), the logits held on the tokens every layer
              routed alike; ``serve()`` of 16 requests cold and again warm
              (the same tokens); one decode step at batch 8 profiled beside
              the bytes of every routed expert it reads; then the sharded
              path (ROADMAP §1 row 22) on a 1×1 mesh over a one-rank NCCL
              group, the rank's tiles being the weights themselves: its
              prefill (kimi-k2's through ``flash_attention`` once, counted
              by the wrapper), its decode and its ``serve()`` tokens equal
              to the one-device path's bit for bit;
    ssm     — (after moe, which frees its weights) rope's tables on the
              card (positions 0–4095, Dh 64, 112, 128) equal the CPU's bit
              for bit, and the card machine's glibc ``sinf``/``cosf`` on
              the same angles (the reference's functions) with its double
              roundings counted; then mamba2-1.3b (48 layers, 1.45 B
              parameters) and zamba2-7b (81 layers, 6.75 B; the shared
              attention + MLP block after every 6th) at full depth and
              published width, bf16 weights from the port's seeded init on
              the card: ``make_prefill_step`` at B = 2, S = 4096 (32
              chunks of 128), zamba2's through ``flash_attention`` 13 times
              at H = KVH = 32, Dh = 112, its last-token logits against the
              same prefill with the plain attention (printed) and each
              application's attention output through the kernel against
              the plain attention's on the same input (held); decode
              against the
              forward on S = 16, each block teacher forced (its decode on
              the forward's input to it) and the whole model (printed; its
              fp32 argmax agreement held); one layer's chunked SSD at full
              width in
              fp32 on S = 512 (4 chunks) against 512 steps of the decode
              recurrence, y and the final state; ``serve()`` as phase lm's,
              cold and warm (the same tokens); one decode step profiled;
              peak memory beside the SSM state's bytes; then the sharded
              path (ROADMAP §1 row 22) on a 1×1 mesh over a one-rank NCCL
              group, the rank's tiles being the weights themselves: its
              prefill (zamba2's through ``flash_attention`` 13 times,
              counted by the wrapper), its decode and its ``serve()``
              tokens equal to the one-device path's bit for bit, its
              decode step's device time within ``MESH_STEP_TOL`` (5 %) of
              one device's;
    xattn   — (after ssm, which frees its weights) whisper-small (12
              encoder + 12 decoder layers, d_model 768, vocab 51865) and
              llama-3.2-vision-11b (40 layers, 8 cross layers, d_model
              4096, vocab 128256; 10.1 B parameters, 20.2 GB) at full depth
              and published width, bf16 weights from the port's seeded
              init on the card, the stub frontends' frames and patches
              ``torch.randn`` from a seeded generator: whisper's
              ``make_prefill_step`` on 8 requests of 1500 frames at S = 448
              (``flash_attention`` × 36: 12 encoder, 12 self, 12 cross),
              against the same prefill with the plain attention;
              ``encode`` (× 12); ``make_serve_step`` greedy for 16 tokens
              at batch 8, cache 64 (× 12 a step: the cross-attention at S =
              1); decode against the forward on S = 16 (bf16 argmax
              agreement > 0.9; an fp32 copy within ``XATTN_FP32_TOL``);
              the VLM's prefill at B = 2, S = 4096 with 1600 patches (× 48:
              40 + 8), against the plain attention's; its greedy serve at
              batch 8 (× 8 a step); its decode through the kernel against
              the plain decode (the forward printed beside it, not held:
              the reference's decode runs the cross layers after all dense
              layers, its forward after every 5th); each model's decode
              step profiled beside the cross K/V projections it recomputes
              every step (the reference keeps no cross cache), timed
              alone; then each model through the sharded path (ROADMAP §1
              row 22) on a 1×1 mesh over a one-rank NCCL group, the
              rank's tiles being the weights themselves: its prefill (×
              36 and × 48, counted by the wrapper), whisper's ``encode``
              (× 12), its decode and its greedy ``make_serve_step`` tokens
              (× 12 and × 8 a step) equal to the one-device path's bit for
              bit, its decode step's device time within
              ``MESH_STEP_TOL`` (5 %) of one device's; then kernel 7 alone
              at each new shape of that path
              (``XATTN_CASES``: non-causal T ≠ S, T off the 64-key tile,
              GQA 4 non-causal, S = 1) against its plain version, with
              times, the bound and SDPA;
    train   — (after xattn) training through ``make_train_step`` on the
              reference's ``_sdpa`` route, each step timed (wall, device
              time from torch.profiler, peak memory, tokens/s, loss,
              gnorm; the card's name and power limit beside each): (a)
              granite-3-2b at full width and depth (bf16, seeded weights)
              on one ``synthetic_token_stream`` batch at train_4k's S =
              4096, B = 2 (B = 1 if the first step peaks above 76 GB),
              4 adamw steps (cosine schedule, remat "dots"), loss and
              gnorm finite, the weights moved, then one adafactor step;
              (a') granite-3-2b at full width and depth through the
              sharded train step on a 1×1 mesh over a one-rank NCCL group
              (``make_host_mesh``; the weights and adamw state its tiles,
              ``shard_params``/``shard_opt_state``) against the
              one-device step on the same weights and batch: loss and
              gnorm, every updated weight, both steps' wall and device
              time and peak memory (NCCL refuses two ranks on one card:
              the multi-rank math is held on CPU gloo ranks by the
              tests); (b) granite-3-2b at full width, 2 layers, fp32: one step on
              the card against the same step on the CPU (loss and gnorm
              rtol 1e-5, each leaf's gradient within 1e-4 of its largest
              |g|); (c) mamba2-1.3b at full depth, B = 2, S = 4096, 3
              steps; (e) deepseek-v3 at full width, 1 layer (26.7 GB),
              B = 1, S = 256: one adafactor step through the sharded train
              step on a 1×1 mesh against the one-device step (loss, aux,
              gnorm, every updated weight; the peak reckoned first and
              the part left out above 76 GB); (f) mamba2-1.3b at full
              depth, B = 2, S = 4096, and (g) zamba2-7b at full width and
              the deepest multiple of 6 layers whose peak is reckoned under
              the card's 80 GB (72; B = 1, S = 256): one adamw step through the
              sharded train step on a 1×1 mesh against the one-device
              step, both with PyTorch's deterministic algorithms, loss,
              gnorm and every updated weight bit for bit; (h)
              whisper-small at full depth (B = 8 requests of 1500 frames,
              S = 448) and (i) llama-3.2-vision-11b at full width cut to
              10 of its 40 layers (2 cross layers; 3.32 B parameters, its
              peak reckoned first: B = 1, S = 4096, 1600 patches): one
              adamw step through the sharded train step on a 1×1 mesh
              against the one-device step the same way, bit for bit; the
              flash kernel launched 0 times in (a)-(c), (e)-(i); (d)
              whisper-small through ``python -m repro_torch.launch.train
              --batch 8 --seq 448`` (the CLI's mesh path: a 1×1 mesh over
              a one-rank NCCL group): 4 steps with a checkpoint every 2,
              and beside it a run stopped after step 2 and resumed to 4;
              the largest |Δ| between the two final checkpoints' leaves;
12. cli     — ``python -m repro_torch.launch.sample`` in a subprocess,
              again with ``--clamp 1=0,3=1``, and ``python -m
              repro_torch.launch.scenarios --scenario all --json ''``
              (every scenario must pass); then, three at once, ``--service
              --service-workers 2`` (the plain run's batch files),
              ``--service-fleet`` and ``--runtime remote`` (a worker
              process on the card each: the seq walks' batch files, 16
              launches reported by the worker); beside them
              ``repro_torch.launch.gateway --port 0 --serve-s`` over phase
              gateway's 2 sites (hard-linked under ``build/``), whose one
              request by the store's name gives the in-process job's
              samples;
    dryrun  — ``python -m repro_torch.launch.dryrun --gbs --mesh single``
              limited to b-m288, and the same with ``--gbs-opt``, and
              ``--arch A --shape decode_32k --mesh single`` for each MoE
              arch at full depth (61 layers, its record without error and
              no device memory allocated), mamba2-1.3b's four cells and
              zamba2-7b's decode_32k and long_500k at full depth (81
              layers, FSDP), whisper-small's train_4k, prefill_32k and
              decode_32k and llama-3.2-vision-11b's decode_32k at full
              depth (40 layers, FSDP) on the card's fakes and again on the
              CPU's (the lines and records equal, no device memory
              allocated on the card): child processes started after
              phase build and read here (the
              other phases keep their process groups); each walks dp,
              tp_single and tp_double as rank 0 of a fake 256-rank group
              on fake tensors on the card; each cell's ``summarize()``
              line, the child's wall time, each cell's
              ``flops_per_device`` == ``dryrun.gbs_flops``' closed form,
              and no device memory allocated by the child's walks
              (``torch.cuda.max_memory_allocated() == 0`` at its end,
              counted from after torch's fake-tensor context, whose one
              real element the child reports apart);
13. timings — per-site kernel, plain and library times and the bound at the
              phase 4/8 shapes; with phases 6, 7, 9 and 10's, printed as the
              ``{"kernels": [...]}`` line (the flash entry's launches: a
              granite prefill's, with kimi-k2's, zamba2's, whisper's and
              the VLM's (one-device and sharded) beside them, and phase
              xattn's shapes).

bf16 inputs: each kernel's outputs within their rounding bound, elementwise
(``site_step.bf16_gemm_bound``: the same bf16-exact products summed in fp32
in two orders differ by at most 2·K·2⁻²⁴·Σ|a||b|; ``site_step_bf16_bounds``
for the measure-first probs).  A draw may differ between a kernel walk and
its plain walk only where the uniform lies within the CDF's bound of a
boundary; each is printed with its margin and its row leaves the later
comparisons; the other rows' log_scale and env agree within 1e-5 per site.

Tolerances: samples equal; env and dlog ``rtol=1e-12, atol=1e-14`` (fp64)
and ``rtol=1e-5, atol=1e-6`` (fp32), with atol taken relative to the
largest |env| (which is 1 after the per-sample rescale).  Displacement
(``displacement_expm.check_rounding``): an element whose exact value is a
normal number within ``rounding_bound`` of the plain version (8·d·ε times
the summed magnitudes of the cancelling terms); one below the smallest
normal number, in both versions, within ``SUBNORMAL_SPACINGS`` (16)
subnormal spacings of the exact value plus what rounding e^{−|μ|²/2} and
the sums moves it; μ = 0 → I exactly.  Flash: fp32
within 1e-5 of the largest |out|; bf16 within
``flash_attention.rounding_bound``, elementwise: the kernel rounds each
weight exp(s − m) to bf16 relative to its running max m, the plain version
relative to the final max, so a weight differs by up to two bf16 roundings
(2·2⁻⁸) and the output by 2⁻⁷·Σ w|v| / Σ w, plus the fp32 sums over T keys
((T·2⁻²² + 2⁻¹⁴)·Σ w|v| / Σ w) and one rounding of the output (2⁻⁷·|out|).
MoE decode against the forward: a token whose route differs in some layer
(the two attention paths round bf16 apart, and a one-ulp change of x swaps
two experts whose router probabilities nearly tie) is counted, at most an
eighth of the tokens, and left out of the logit comparison with the tokens
after it in its row when it was not the last layer; the argmax agreement
is held > 0.9 (the reference's own decode-vs-prefill criterion).
SSM: the chunked SSD against the step recurrence in fp32 within
``SSD_TOL`` (1e-4) of the largest |y| and |state| (sums of up to 512
terms in other orders; the CPU tests hold 1e-5 at S ≤ 12).  Decode
against the forward, and zamba2's prefill through the flash kernel
against the plain attention: each block's on its own input within
``LM_LOGIT_TOL`` of its largest |output|; through the whole model the
logits are printed and the fp32 argmax agreement held > 0.9, because a
random-weight Mamba2 stack amplifies roundings with depth (the
reference's own bf16 decode and forward differ by 0.093 of the logits'
scale at 8 layers of mamba2's width on the CPU, the port's by 0.10; at
48 layers on the card the port's by 0.98 in bf16 and 0.053 in fp32).
Encoder-decoder and VLM (phase xattn): prefill through the kernel against
the plain attention, and the VLM's decode through it against the plain
decode, within ``LM_LOGIT_TOL`` of the largest |logit|; whisper's decode
against its forward: bf16 argmax agreement > 0.9, fp32 within
``XATTN_FP32_TOL`` (1e-3) of the largest |logit|.
LM logits (bf16 through 40 layers):
within 5e-2 of the largest |logit| (a 40-layer bf16 stand-in on the CPU
drifted 1.5e-2 between decode and forward).  The argmax agreement is
printed, not held: among 49155 random-weight logits near-ties are common
(the stand-in agreed on 0.94 of the positions).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {torch.float64: dict(rtol=1e-12, atol=1e-14),
       torch.float32: dict(rtol=1e-5, atol=1e-6)}
SMALL_SHAPES = [(8, 4, 3), (37, 13, 5), (64, 32, 2), (1000, 257, 4)]
SCALINGS = ("none", "per_sample", "global")

# jiuzhang2 (repro/configs/gbs.py): M=144, χ=10⁴, d=4 — depth cut to fit
CHI, D = 10_000, 4
LINEAR_SITES, LINEAR_N = 8, 1024
BORN_SITES, BORN_N = 4, 512

# NVIDIA H100 SXM data sheet (dense), at 700 W: HBM3 bandwidth, the FP64
# tensor-core peak (the card's fp64 GEMM rate), fp32 outside the tensor
# cores, and the bf16 tensor-core peak (the dry run's roofline constants)
sys.path.insert(0, str(SRC))
from repro_torch.launch.costs import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                      PEAK_FLOPS as PEAK_BF16_FLOPS,
                                      PEAK_FP32_FLOPS, PEAK_FP64_FLOPS)

# the stream phase: jiuzhang2 at full width with the depth cut to 24 sites,
# a bf16 GammaStore of 19.2 GB on disk that decodes to 76.8 GB of fp64
STREAM_SITES = 24
STREAM_BUDGET = 16e9          # plan_stream's segment length 2 at N = 1024
STREAM_BUCKETS = (256, 1024, 4096, 10_000)
STREAM_STAGES = [(0, 5, 256), (5, 7, 1024), (7, 8, 4096), (8, 15, 10_000),
                 (15, 16, 4096), (16, 18, 1024), (18, 24, 256)]
STREAM_TP_SITES = 4           # the dp / tp walks stream the first 4 sites
STREAM_STOP = 3               # resume: stopped after 3 segments
STREAM_DECODE = (7, 2)        # the read path checked on sites 7 and 8
TIMED_N_CAP = 65_536
TIMED_BUDGET = 47e9           # segment length 2 at N = 65,536

DISP_BATCH = 2 ** 20
# |μ| ranges where D(μ)'s sums reach below the smallest normal number, as
# the tile sweep reports them: (dtype, low, high, log-uniform), 2¹⁶ draws at
# d = 16
SUBNORMAL_RANGES = [(torch.float32, 1e-3, 1e-2, True),
                (torch.float32, 13.2, 14.2, False),
                (torch.float64, 1e-22, 1e-19, True),
                (torch.float64, 37.7, 38.5, False)]
DISP_DS = (4, 16)                 # jiuzhang2's cutoff (configs/gbs.py), max
# (B, S, H, KVH, Dh, dtype, causal): granite-3-2b first (the lm phase's),
# kimi-k2-1t-a32b's prefill at Dh = 112 (phase moe's) after its variants,
# then zamba2-7b's shared attention (phase ssm's: Dh = 112, KVH = H)
FLASH_CASES = [(2, 4096, 32, 8, 64, torch.bfloat16, True),
               (2, 4096, 32, 8, 64, torch.bfloat16, False),
               (2, 4096, 32, 32, 128, torch.bfloat16, True),
               (2, 4096, 32, 1, 64, torch.bfloat16, True),
               (2, 1024, 32, 8, 64, torch.float32, True),
               (2, 4096, 64, 8, 112, torch.bfloat16, True),
               (2, 1024, 64, 8, 112, torch.float32, True),
               (2, 4096, 32, 32, 112, torch.bfloat16, True)]
LM_ARCH, LM_BATCH, LM_SEQ = "granite-3-2b", 2, 4096
LM_LOGIT_TOL = 5e-2
SERVE = dict(requests=16, batch=8, max_new=16, cache_len=64)
# phase moe: (arch, depth kept, prefill batch, prefill length); published
# widths, the depth cut so that the bf16 weights fit one 80 GB card
MOE_RUNS = (("deepseek-v3-671b", 2, 2, 2048),
            ("kimi-k2-1t-a32b", 1, 2, 4096))
MOE_DECODE_SEQ = 16
# phase ssm: the SSM and hybrid archs at full depth and published width
SSM_ARCHS = ("mamba2-1.3b", "zamba2-7b")
MESH_STEP_TOL = 0.05          # the 1×1 decode step's device time, of one
#                               device's (phases ssm and xattn)
SSD_CHECK_SEQ = 512           # one layer's chunked SSD (4 chunks of 128)
SSD_TOL = 1e-4                # fp32, of the largest |y| and |state|
ROPE_HEAD_DIMS = (64, 112, 128)
# phase xattn: whisper-small and llama-3.2-vision-11b at full depth and
# published width; whisper's 8 requests of 1500 frames at its published
# text context of 448, the VLM's prefill as granite's (B = 2, S = 4096)
XATTN_ARCHS = ("whisper-small", "llama-3.2-vision-11b")
WHISPER_BATCH, WHISPER_TEXT = 8, 448
XATTN_FP32_TOL = 1e-3
XATTN_DECODE_SEQ = 16
# kernel 7 at the shapes of that path: (B, S, T, H, KVH, Dh, causal, where)
XATTN_CASES = [(8, 1500, 1500, 12, 12, 64, False, "whisper encoder"),
               (8, 448, 448, 12, 12, 64, True, "whisper decoder self"),
               (8, 448, 1500, 12, 12, 64, False, "whisper cross"),
               (8, 1, 1500, 12, 12, 64, False, "whisper decode cross"),
               (2, 4096, 4096, 32, 8, 128, True, "vlm self"),
               (2, 4096, 1600, 32, 8, 128, False, "vlm cross"),
               (8, 1, 1600, 32, 8, 128, False, "vlm decode cross")]

# phase train: granite-3-2b at full width and depth on train_4k's sequence,
# its global batch of 256 cut to TRAIN_BATCH (TRAIN_BATCH_MIN if the first
# step passes TRAIN_PEAK_GB); the fp32 check at full width, depth and shape
# cut (depth, B, S); mamba2-1.3b at full depth; whisper-small through the
# CLI (batch, text length, steps, checkpoint cadence, the stopped run's step)
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS = "granite-3-2b", 4096, 4
TRAIN_BATCH, TRAIN_BATCH_MIN, TRAIN_PEAK_GB = 2, 1, 76.0
TRAIN_CHECK = (2, 1, 256)
TRAIN_GRAD_TOL = 1e-4         # of a leaf's largest |g|, the CPU tests' fp32
TRAIN_SSM = ("mamba2-1.3b", 2, 4096, 3)
TRAIN_MOE = ("deepseek-v3-671b", 1, 1, 256)   # arch, depth, B, S: adafactor
TRAIN_SSM_MESH = ("mamba2-1.3b", 2, 4096)      # arch, B, S: the 1×1 mesh
TRAIN_HYBRID = ("zamba2-7b", 1, 256)           # arch, B, S: adamw, its depth
TRAIN_HYBRID_GB = 80.0        # the card's memory, which that depth's peak
#                               is reckoned under (the reckoning ran 1.6 GB
#                               above the measured peak at 66 layers)
TRAIN_WHISPER_MESH = ("whisper-small", 8, 448)  # arch, B, S: the 1×1 mesh
TRAIN_VLM = ("llama-3.2-vision-11b", 10, 1, 4096)  # arch, depth, B, S: the
#                               1×1 mesh, adamw; the depth a multiple of
#                               cross_attn_every (2 cross layers)
TRAIN_CLI = dict(arch="whisper-small", batch=8, seq=448, steps=4, every=2,
                 stop=2, extra=())

# the dryrun phase: the GBS preset its two children walk (plain and
# --gbs-opt) on the 16×16 mesh, the LM arch whose cells (train_4k,
# prefill_32k, decode_32k; long_500k is skipped) the plain child walks too
# (--gbs-opt its train_4k at --remat-block 4) and two more children walk
# on the CPU, and their time limit from their start
DRYRUN_PRESET = "b-m288"
DRYRUN_LM_ARCH = "granite-3-2b"
DRYRUN_LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_REMAT_BLOCK = 4
DRYRUN_MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")  # decode_32k
# the SSM and hybrid children, on the card's fakes and again on the CPU's:
# mamba2-1.3b's four cells, zamba2-7b's decode cells at full depth (FSDP)
DRYRUN_SSM = {"mamba2-1.3b": ("train_4k", "prefill_32k", "decode_32k",
                              "long_500k"),
              "zamba2-7b": ("decode_32k", "long_500k")}
# the encoder-decoder and VLM children, the same way: whisper-small's three
# cells, llama-3.2-vision-11b's decode_32k at full depth (FSDP)
DRYRUN_XATTN = {"whisper-small": ("train_4k", "prefill_32k", "decode_32k"),
                "llama-3.2-vision-11b": ("decode_32k",)}
DRYRUN_PAIRED = {"ssm": DRYRUN_SSM, "xattn": DRYRUN_XATTN}
DRYRUN_SECONDS = 900
DRYRUN_ARGS = ()              # more flags for the card's children

# the tp phase: (scheme, measure_first) → kernels its walk must launch M times
TP_WALKS = {("dp", False): ("site_step_linear",),
            ("tp_single", False): ("contract_measure",),
            ("tp_single", True): ("measure_probs", "collapse_select"),
            ("tp_double", False): ("contract_measure",)}
TP_SHARDS = 4                     # the kernels are timed at p₂ = 4 shards
# the clamp phase: outcomes forced on phase 4's chain (scalar on three
# sites; per sample, (7·n) mod d, on one) and on the Born chain
CLAMP_SCALAR = {1: 0, 4: 1, 6: 0}
CLAMP_PER_SAMPLE_SITE = 5
CLAMP_BORN = {2: 3}
CLAMP_STREAM = {1: 0, 3: 1}       # stream (f), on the 4-site sub-store
CLAMP_SCHEMES = (("dp", False), ("tp_single", False), ("tp_single", True),
                 ("tp_double", False))
# the small phase's clamped walks: (N, χ, d) with N = 1 and odd, χ off the
# kernels' tiles, d = 3
CLAMP_SMALL = [(1, 13, 3), (37, 130, 3), (301, 257, 4)]
# the service phase: macro batches of a job, thread lanes, fleet workers
SHARD_SEED = 29               # phase shard's 2-batch job key (4 sites)
SHARD_HOSTS = (2, 4)          # (a)'s emulated clusters, a site a block
SHARD_ROT = (2, 3)            # (d): rank 0's rotted copy, then rank 1's
GATEWAY_SEED = 17             # phase gateway's first job (2 sites)
GATEWAY_N = 1024              # its N (the job total), in 2 batches
GATEWAY_TENANTS = (("alice", "alice-key", None), ("bob", "bob-key", 1))
SERVICE_BATCHES = 4
SERVICE_LANES = 2
SERVICE_WORKERS = 2
SERVICE_SEED = 13             # the streamed jobs' key
SERVICE_SITES = 2             # its streamed parts: the first 2 sites,
SERVICE_SEGMENT = 1           # one site (800 MB) a segment
STOP_CUTS = (SERVICE_SITES, 1)  # (d)'s unclean stop: each process's last
#                                 boundary
# the kernels that run on the tensor cores, by name prefix (each must match
# a built kernel), and the instructions each must hold: mma.sync (HMMA, and
# DMMA for fp64), or wgmma (HGMMA) fed by TMA loads (UTMALDG)
TENSOR_CORE_KERNELS = {"flash_tc_kernel<64>": ("HMMA",),
                       "flash_tc_kernel<112>": ("HMMA",),
                       "flash_tc_kernel<128>": ("HMMA",),
                       "wgmma_bf16_kernel": ("HGMMA", "UTMALDG"),
                       "contract_f64_kernel<0>": ("DMMA",),
                       "contract_f64_kernel<1>": ("DMMA",),
                       "contract_c128_kernel<0>": ("DMMA",),
                       "contract_c128_kernel<1>": ("DMMA",),
                       **{f"collapse_f64_kernel<{a}, {b}>": ("DMMA",)
                          for a in (0, 1) for b in (0, 1)}}
SASS_OPS = ("HMMA", "DMMA", "HGMMA", "UTMALDG")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _phase(name: str, t0: float) -> None:
    print(f"[phase {name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare(name: str, got, want) -> float:
    """Samples equal; env and dlog within TOL; returns the max abs error."""
    e_g, s_g, d_g = got
    e_w, s_w, d_w = want
    bad = (s_g != s_w).nonzero().flatten()
    check(bad.numel() == 0, f"{name}: samples differ in {bad.numel()} rows "
          f"(first {bad[:8].tolist()})")
    check(e_g.dtype == e_w.dtype and e_g.shape == e_w.shape,
          f"{name}: env {e_g.dtype}{tuple(e_g.shape)} vs "
          f"{e_w.dtype}{tuple(e_w.shape)}")
    tol = TOL[d_w.dtype]
    scale = max(1.0, e_w.abs().max().item())
    check(torch.allclose(e_g / scale, e_w / scale, **tol),
          f"{name}: env differs (max abs "
          f"{(e_g - e_w).abs().max().item():.3e}, scale {scale:.3e})")
    check(torch.allclose(d_g, d_w, **tol),
          f"{name}: dlog differs (max abs "
          f"{(d_g - d_w).abs().max().item():.3e})")
    return max((e_g - e_w).abs().max().item(), (d_g - d_w).abs().max().item())


def operands(semantics: str, real: torch.dtype, n: int, chi: int, d: int,
             seed: int, device):
    """Seeded numpy operands: linear non-negative, Born complex Gaussian."""
    rng = np.random.default_rng(seed)
    npr = np.float64 if real == torch.float64 else np.float32
    u = rng.uniform(size=n).astype(npr)
    if semantics == "linear":
        env = rng.uniform(size=(n, chi)).astype(npr)
        gamma = rng.uniform(size=(chi, chi, d)).astype(npr)
        lam = rng.uniform(size=chi).astype(npr)
    else:
        npc = np.complex128 if real == torch.float64 else np.complex64
        env = (rng.normal(size=(n, chi))
               + 1j * rng.normal(size=(n, chi))).astype(npc)
        gamma = (rng.normal(size=(chi, chi, d))
                 + 1j * rng.normal(size=(chi, chi, d))).astype(npc)
        lam = (rng.uniform(size=chi) + 0.5).astype(npr)
    return [torch.from_numpy(a).to(device) for a in (env, gamma, lam, u)]


def time_ms(fn, reps: int) -> float:
    """Median device time of one call (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_state(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz), power draw (W) and temperature (°C) that
    nvidia-smi reads every 100 ms while ``fn`` runs back to back, to keep
    beside the times measured in the same run."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    cols = [statistics.median(c) for c in zip(*rows)] if rows else [None] * 3
    return dict(zip(("sm_mhz", "power_w", "temp_c"), cols))


def kernel_name(raw: str) -> str:
    """A CUDA kernel's name as the profiler gives it, without ``void``, the
    anonymous namespace and the parameter list: the function and its
    template arguments, which may hold parentheses of their own
    (``probs_draw_kernel<double, ((anonymous namespace)::Measure)2>``)."""
    name = raw.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def device_breakdown(fn, expect: int | None = None, reps: int = 5) -> dict:
    """{kernel: [device ms, launches]} of one call of ``fn``, from
    torch.profiler over ``reps`` calls in one window after a warm-up call.
    Late in a long process the profiler has left launches out of a window
    (a call's first kernel or two, one launch of twenty; a spin kernel of
    up to 200 ms before the calls did not stop it), so a kernel's time is
    the mean over its launches listed, and its launches a call their count
    over ``reps``, rounded; each launch left out is printed.  ``expect``:
    the repo's own kernels a call (all but PyTorch's ``at::`` ones)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            times.setdefault(kernel_name(ev.name), []).append(
                ev.time_range.elapsed_us() / 1e3)
    out = {k: [statistics.fmean(v), round(len(v) / reps)]
           for k, v in times.items()}
    missing = sum(max(0, c * reps - len(times[k])) for k, (_, c) in out.items())
    if missing:
        print(f"torch.profiler left out {missing} of the kernel launches of "
              f"{reps} calls", flush=True)
    if expect is not None:
        ours = sum(c for k, (_, c) in out.items() if not k.startswith("at::"))
        check(ours == expect, f"the profiler lists {ours} of the call's "
              f"{expect} kernels: {sorted(out)}")
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0] * kv[1][1]))


def breakdown_of(fn, names, expect: int, reps: int = 5) -> dict:
    """``device_breakdown`` of ``fn``, held to ``expect`` of the repo's own
    kernels a call and to every kernel named by a prefix in ``names``.  A
    window is taken again (up to five) while it falls short: late in a
    long process the profiler has left a kernel, or most launches of a
    window, out; a call that launches other kernels fails every window."""
    for _ in range(5):
        parts = device_breakdown(fn, reps=reps)
        missing = [p for p in names if not any(k.startswith(p) for k in parts)]
        ours = sum(c for k, (_, c) in parts.items()
                   if not k.startswith("at::"))
        if not missing and ours == expect:
            return parts
        print(f"torch.profiler listed {ours} of {expect} kernels a call"
              + (f", none of {missing}" if missing else "")
              + "; another window", flush=True)
    check(False, f"the profiler lists {ours} of the call's {expect} "
          f"kernels: {sorted(parts)}")


def _rate(flops: float, parts: dict, prefix: str):
    """TFLOP/s of the kernels named ``prefix`` in a breakdown, None if the
    profiler listed none."""
    ms = sum(t * c for k, (t, c) in parts.items() if k.startswith(prefix))
    return flops / ms / 1e9 if ms > 0 else None


def device_time_ms(fn, reps: int = 20, kernels: int | None = None) -> float:
    """Device time of one call: its kernels' durations (``device_breakdown``
    over ``reps`` calls; ``kernels``: the repo's own a call).  For calls
    whose kernels finish sooner than the host launches them, where CUDA
    events around the call time the host.  A window in which the profiler
    lists no kernel at all is taken again (up to five): it has left a whole
    window out, and a call on the card launches at least one kernel."""
    for _ in range(5):
        parts = device_breakdown(fn, reps=reps)
        if parts:
            break
        print("torch.profiler listed no kernel of the call; taking the "
              "window again", flush=True)
    check(bool(parts), "torch.profiler listed no kernel of the call in five "
          "windows")
    if kernels is not None:
        ours = sum(c for k, (_, c) in parts.items() if not k.startswith("at::"))
        check(ours == kernels, f"the profiler lists {ours} of the call's "
              f"{kernels} kernels: {sorted(parts)}")
    return sum(ms * c for ms, c in parts.values())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> torch.device:
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(nvidia_smi(), flush=True)
    # comparisons on the card: no TF32 in fp32 products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; TF32 off", flush=True)
    _phase("device", t0)
    return torch.device("cuda", 0)


def phase_build() -> tuple[dict, dict]:
    """Build every source; returns registers and spill bytes, and the
    tensor-core instructions, by kernel."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build seconds: {json.dumps(_build.build_seconds)}")
    ptxas = {}
    for name in _build.SIGNATURES:
        ptxas.update(_build.ptxas_kernels(_build.ptxas_log(name)))
    print(f"ptxas (registers, spill bytes) by kernel: {json.dumps(ptxas)}")
    mma = tensor_core_instructions()
    print(f"tensor-core instructions (cuobjdump -sass): {json.dumps(mma)}")
    for prefix, ops in TENSOR_CORE_KERNELS.items():
        found = [fn for fn in mma if fn.startswith(prefix)]
        check(bool(found), f"no built kernel named {prefix}")
        for fn in found:
            for op in ops:
                check(mma[fn].get(op, 0) > 0, f"{fn} has no {op} instruction")
            spills = ptxas.get(fn, {}).get("spill_stores", 0)
            check(spills == 0, f"{fn} spills {spills} bytes")
    _phase("build", t0)
    return ptxas, mma


def tensor_core_instructions() -> dict:
    """Tensor-core and TMA instructions (``SASS_OPS``) per kernel in the
    built libraries."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts: dict = {}
    for name in _build.SIGNATURES:
        sass = subprocess.run([tool, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = _build._short_name(m.group(1))
            m = re.search(r"\b(" + "|".join(SASS_OPS) + r")\b", line)
            if fn and m:
                per = counts.setdefault(fn, {})
                per[m.group(1)] = per.get(m.group(1), 0) + 1
    return counts


def phase_small(device) -> None:
    from repro_torch.core import prng
    from repro_torch.kernels import site_impls as SI

    t0 = time.perf_counter()
    cells = {"linear": (SI.site_step_linear_cuda, SI.site_step_linear_torch),
             "born": (SI.site_step_born_cuda, SI.site_step_born_torch)}
    worst = 0.0
    for semantics, (kernel, plain) in cells.items():
        for real in (torch.float64, torch.float32):
            for n, chi, d in SMALL_SHAPES:
                env, gamma, lam, u = operands(semantics, real, n, chi, d,
                                              seed=n + chi + d, device=device)
                for scaling in SCALINGS:
                    kw = dict(scaling=scaling, compute_dtype=None)
                    got = kernel(env, gamma, lam, u[:, None], **kw)
                    want = plain(env, gamma, lam, u[:, None], **kw)
                    torch.cuda.synchronize()
                    worst = max(worst, compare(
                        f"{semantics} {real} {(n, chi, d)} {scaling}",
                        got, want))
    print(f"kernel = plain on {2 * 2 * len(SMALL_SHAPES) * len(SCALINGS)} "
          f"small cases (max abs err {worst:.3e})")
    key = prng.fold_in(prng.key(2 ** 31 + 5), 11)
    for dt in (torch.float32, torch.float64):
        on_card = prng.uniform(key, (4099, 1), dtype=dt, device=device).cpu()
        on_cpu = prng.uniform(key, (4099, 1), dtype=dt)
        check(torch.equal(on_card.view(torch.uint8), on_cpu.view(torch.uint8)),
              f"threefry uniform {dt}: card and CPU bits differ")
    print("threefry uniform: card == CPU bit for bit (float32, float64)")
    _small_clamped(device)
    _phase("small", t0)


def _clamp_arrays(spec, n_sites: int, n: int, start: int = 0):
    """A clamp spec's (mask (L,), vals (L, N)) for sites [start, start+L)."""
    from repro_torch.workloads import clamp as WC

    return WC.segment_clamp_arrays(WC.clamp_map(WC.normalize_clamp(spec)),
                                   start, n_sites, n)


def _small_clamped(device) -> None:
    """The clamped walk with the kernels against its plain walk on
    awkward shapes (``CLAMP_SMALL``), fp64 and fp32, a scalar and a
    per-sample clamp: samples equal, env, log_scale and log_prob within
    TOL, ``contract_measure`` launched once a site."""
    from repro_torch.core import clamped as CL
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.core import sampler as S
    from repro_torch.kernels import contract_measure as CM

    sites, worst, cases = 5, 0.0, 0
    for n, chi, d in CLAMP_SMALL:
        for real in (torch.float64, torch.float32):
            mps = M.random_linear_mps(prng.key(n + chi), sites, chi, d,
                                      dtype=real, device=device)
            for spec in ({1: 0, 3: d - 1},
                         {2: [(7 * i) % d for i in range(n)]}):
                mask, vals = _clamp_arrays(spec, sites, n)
                out = {}
                for kernels in ("cuda", "torch"):
                    cfg = S.SamplerConfig(kernels=kernels)
                    st = S.init_state(mps, n, prng.key(4), cfg)
                    before = CM.LAUNCHES["contract_measure"]
                    out[kernels] = CL.clamped_segment(
                        mps.gammas, mps.lambdas, st.env, st.key, 0, mask,
                        vals, cfg, log_scale=st.log_scale)
                    out[kernels + "/launches"] = (
                        CM.LAUNCHES["contract_measure"] - before)
                torch.cuda.synchronize()
                label = f"clamped {real} {(n, chi, d)} {sorted(spec)}"
                check(out["cuda/launches"] == sites, f"{label}: "
                      f"contract_measure launched {out['cuda/launches']}")
                (s_k, e_k, l_k, p_k), (s_p, e_p, l_p, p_p) = (out["cuda"],
                                                             out["torch"])
                check(bool((s_k.cpu().numpy()[mask] == vals[mask]).all()),
                      f"{label}: the clamp does not hold")
                worst = max(worst, compare(label, (e_k, s_k, l_k),
                                           (e_p, s_p, l_p)))
                check(torch.allclose(p_k, p_p, **TOL[real]),
                      f"{label}: log_prob differs (max abs "
                      f"{(p_k - p_p).abs().max().item():.3e})")
                worst = max(worst, (p_k - p_p).abs().max().item())
                cases += 1
    print(f"clamped walk: kernels = plain on {cases} small cases (max abs "
          f"err {worst:.3e})", flush=True)


def _walk(mps, n, key, kernels: str):
    """The chain walk through the core sampler (for log_scale)."""
    from repro_torch.core import sampler as S

    cfg = S.SamplerConfig(semantics=mps.semantics, kernels=kernels)
    return S.sample_chain(mps, S.init_state(mps, n, key, cfg), cfg)


def phase_full(device, semantics: str):
    """Full-width walk through the session with the kernels, checked against
    the plain version on the card; then per-site timings on site 0.
    Returns (the kernel's entry, the chain, the walk's final env)."""
    from repro_torch import api
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    linear = semantics == "linear"
    sites, n = (LINEAR_SITES, LINEAR_N) if linear else (BORN_SITES, BORN_N)
    name = "site_step_linear" if linear else "site_step_born"
    torch.cuda.reset_peak_memory_stats(device)
    tb = time.perf_counter()
    if linear:
        mps = M.gbs_like_mps(prng.key(1234), sites, CHI, D,
                             dtype=torch.float64, device=device)
    else:
        mps = M.random_born_mps(prng.key(1234), sites, CHI, D,
                                dtype=torch.complex128, device=device)
    torch.cuda.synchronize()
    chain_gb = mps.gammas.numel() * mps.gammas.element_size() / 1e9
    print(f"{semantics}: chain (M, χ, d)=({sites}, {CHI}, {D}) "
          f"{mps.gammas.dtype} {chain_gb:.3f} GB built in "
          f"{time.perf_counter() - tb:.3f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")

    key = prng.key(7)
    # the main path: counts set to 0 just before, read just after
    ops.reset_launches()
    tw = time.perf_counter()
    with api.SamplingSession(mps, api.SamplerConfig(kernels="cuda"),
                             device=device) as session:
        samples = session.sample(n, key)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - tw
    launches = ops.launch_counts()
    print(f"{semantics}: session walk N={n} in {walk_s:.3f} s; "
          f"launches {launches}")
    check(launches[name] == sites, f"{name} launched {launches[name]} times "
          f"on the main path, expected {sites}")
    check(samples.shape == (n, sites) and samples.min() >= 0
          and samples.max() < D, f"{semantics}: bad samples")

    kern = _walk(mps, n, key, "cuda")
    plain = _walk(mps, n, key, "torch")
    torch.cuda.synchronize()
    check(np.array_equal(kern.samples.T.cpu().numpy(), samples),
          f"{semantics}: session and core walk differ")
    bad = int((kern.samples != plain.samples).sum())
    check(bad == 0, f"{semantics}: kernel and plain walks differ in {bad} "
          f"draws")
    tol = TOL[torch.float64]
    check(torch.isfinite(kern.state.log_scale).all().item()
          and torch.allclose(kern.state.log_scale, plain.state.log_scale,
                             **tol),
          f"{semantics}: log_scale differs (max abs "
          f"{(kern.state.log_scale - plain.state.log_scale).abs().max():.3e})")
    print(f"{semantics}: kernel walk == plain walk ({sites * n} draws), "
          f"log_scale max abs diff "
          f"{(kern.state.log_scale - plain.state.log_scale).abs().max():.3e}")

    # per-site timings on site 0, from the walk's final (rescaled) env
    env, gamma, lam = kern.state.env, mps.gammas[0], mps.lambdas[0]
    u = prng.uniform(prng.fold_in(key, 0), (n,), dtype=lam.dtype,
                     device=device)
    wrapper = K.site_step_linear if linear else K.site_step_born
    plain_fn = K.site_step_linear_plain if linear else K.site_step_born_plain
    err = compare(f"{semantics} full width site", wrapper(env, gamma, lam, u),
                  plain_fn(env, gamma, lam, u))
    reps = 5
    ms = time_ms(lambda: wrapper(env, gamma, lam, u), reps)
    plain_ms = time_ms(lambda: plain_fn(env, gamma, lam, u), reps)
    g2 = gamma.reshape(CHI, CHI * D)
    library_ms = time_ms(lambda: torch.matmul(env, g2), reps)
    # linear: W pass, probs and draw, bucket sort, collapse, rescale; Born:
    # contraction, probs and draw, gather, rescale
    parts = device_breakdown(lambda: wrapper(env, gamma, lam, u),
                             5 if linear else 4)
    print(f"{semantics}: device ms by kernel in one {name} call "
          f"(torch.profiler): {json.dumps(parts)}")

    el = env.element_size()
    moved = (env.numel() * el + gamma.numel() * el + lam.numel() * 8
             + u.numel() * 8                          # inputs, read once
             + env.numel() * el + n * 8 + n * 8)      # env', samples, dlog
    if linear:   # W pass + probs + grouped collapse (1/d of the contraction)
        flops = 2 * CHI * CHI * D + 2 * n * CHI * D + 2 * n * CHI * CHI
    else:        # the full complex contraction (8 flops per complex MAC);
        flops = 8 * n * CHI * CHI * D   # env' is a gather of temp, no flops
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    entry = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/site_step.cu",
        "replaces": ("src/repro/kernels/site_step.py:181" if linear
                     else "src/repro/kernels/site_step.py:303"),
        "launches": launches[name], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shape": {"n": n, "chi": CHI, "d": D, "dtype": str(env.dtype)},
        "walk_s": walk_s, "sites": sites,
    }
    print(f"{semantics}: per site ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.3f} bound_ms={entry['bound_ms']:.3f} "
          f"({entry['bound_by']}: {moved / 1e9:.3f} GB, "
          f"{flops / 1e12:.4f} TFLOP)")
    # the GEMM's share of the step, from the profiler's kernels: the Born
    # contraction, the linear step's grouped collapse (2·N·χ² flops)
    gemm_kernel = "collapse_f64_kernel" if linear else "contract_c128_kernel"
    gemm = sum(ms * c for k, (ms, c) in parts.items()
               if k.startswith(gemm_kernel))
    ours = sum(ms * c for k, (ms, c) in parts.items()
               if not k.startswith("at::"))
    check(gemm > 0, f"{semantics}: the profiler lists no {gemm_kernel}")
    entry.update(
        tflops=flops / ms / 1e9, library_tflops=flops / library_ms / 1e9,
        of_bound=entry["bound_ms"] / ms, gemm_share=gemm / ours, parts=parts,
        device_state=device_state(lambda: wrapper(env, gamma, lam, u)),
        library_device_state=device_state(lambda: torch.matmul(env, g2)))
    if linear:
        entry["collapse_tflops"] = 2 * n * CHI * CHI / gemm / 1e9
    print(f"{semantics}: {entry['tflops']:.2f} TFLOP/s (cuBLAS's "
          f"{'' if linear else 'complex '}matmul of the whole contraction "
          f"{entry['library_tflops']:.2f} in {library_ms:.3f} ms), "
          f"{entry['of_bound']:.1%} of the {entry['bound_ms']:.3f} ms bound; "
          f"{gemm_kernel} {gemm:.3f} of {ours:.3f} device ms "
          f"({entry['gemm_share']:.1%}"
          + (f", {entry['collapse_tflops']:.2f} TFLOP/s" if linear else "")
          + f"); card while kernel and library run "
          f"{json.dumps(entry['device_state'])}, "
          f"{json.dumps(entry['library_device_state'])}", flush=True)
    del kern, plain, gamma, lam, u, g2
    torch.cuda.empty_cache()
    _phase(semantics, t0)
    return entry, mps, env


def phase_nccl(device):
    """A real one-rank NCCL process group and a 1×1 ("data", "model") mesh
    (the card is one GPU; NCCL refuses two ranks on one)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    mesh = make_mesh(1, device)
    x = torch.arange(4.0, device=device)
    dist.all_reduce(x, group=mesh.group("model"))
    torch.cuda.synchronize()
    check(x.tolist() == [0.0, 1.0, 2.0, 3.0], f"NCCL all_reduce gave {x}")
    print(f"NCCL {torch.cuda.nccl.version()}: mesh {mesh.shape} on "
          f"{mesh.device}", flush=True)
    _phase("nccl", t0)
    return mesh


# ---------------------------------------------------------------------------
# stream: a chain too large for the card, walked from a GammaStore
# ---------------------------------------------------------------------------

def _engine_walk(store, device, n, key, kernels, **kw):
    """A ``StreamingEngine`` walk: (samples, final state, stats)."""
    from repro_torch.core import sampler as S
    from repro_torch.engine import StreamingEngine, StreamPlan

    eng = StreamingEngine(store, config=S.SamplerConfig(kernels=kernels),
                          plan=StreamPlan(segment_len=2), device=device, **kw)
    try:
        out = eng.sample(n, key)
        torch.cuda.synchronize()
        return out, eng.state, dict(eng.stats)
    finally:
        eng.close(close_store=False)


def _same_state(name, got, want) -> tuple[float, float]:
    """Samples equal; env and log_scale of the final states within TOL."""
    bad = int((got[0] != want[0]).sum())
    check(bad == 0, f"{name}: samples differ in {bad} draws")
    return _same_walk(name, (torch.zeros(1), got[1].env, got[1].log_scale),
                      (torch.zeros(1), want[1].env, want[1].log_scale))


def _stream_io(stats) -> dict:
    """Read, copy and compute rates and the overlap share of a walk."""
    read, comp, wall = stats["store_io_s"], stats["compute_s"], \
        stats["wall_s"]
    return {"wall_s": wall, "io_wait_s": stats["io_wait_s"],
            "read_s": read, "h2d_s": stats["h2d_s"], "compute_s": comp,
            "read_gb": stats["io_bytes"] / 1e9,
            "read_gbps": stats["io_bytes"] / read / 1e9,
            "h2d_gbps": (stats["h2d_bytes"] / stats["h2d_s"] / 1e9
                         if stats["h2d_s"] else None),
            "overlap": (read + comp - wall) / min(read, comp),
            "io_hidden_frac": stats["io_hidden_frac"],
            "max_live_segments": stats["max_live_segments"],
            "segments": stats["segments"]}


def phase_stream(device, mesh, registry) -> dict:
    """jiuzhang2 at full width (χ = 10⁴, d = 4, fp64) with the depth cut to
    24 sites, written to a bf16 GammaStore (19.2 GB; 76.8 GB decoded, more
    than the card holds), its read path on the card checked bit for bit
    against an independent decode, and streamed: (a) the flat-χ seq walk through the
    session with the kernels, and with the plain cells; (b) dyn-χ, against
    the in-memory staged walk; (c) stop and resume; (d) dp and the TP
    schemes on the one-rank mesh over the first 4 sites; (e) one timed walk
    at the macro batch that should hide the reads."""
    from repro_torch.data.gamma_store import GammaStore

    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="stream_") as root:
        out["write"] = _stream_write(root, device)
        store = GammaStore(root, torch.bfloat16, torch.float64)
        try:
            out["decode"] = _stream_decode(store, device)
            out["flat"] = _stream_flat(store, device)
            out["dyn"] = _stream_dyn(store, device)
            out["resume"] = _stream_resume(store, device, build,
                                           out["flat"].pop("samples"))
            out["tp"], out["service"], out["shard"], out["gateway"] = \
                _stream_tp(root, device, mesh, build, registry)
            out["timed"] = _stream_timed(store, device,
                                         out["flat"]["io"]["read_gbps"])
        finally:
            store.close()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    check(left < 2 ** 30, f"the stream phase left {left / 1e9:.3f} GB on "
          "the card")
    _phase("stream", t0)
    return out


def _stream_write(root, device) -> dict:
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore

    site = CHI * CHI * D
    need = STREAM_SITES * site * 2 + 2 ** 30
    free = shutil.disk_usage(root).free
    print(f"stream: {free / 1e9:.1f} GB free under {root}; the store needs "
          f"{need / 1e9:.1f} GB", flush=True)
    check(free >= need, f"not enough disk for the stream phase's store: "
          f"{free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed")
    tw = time.perf_counter()
    with GammaStore(root, storage_dtype=torch.bfloat16,
                    compute_dtype=torch.float64) as st:
        for i in range(STREAM_SITES):
            g, lam = M.gbs_like_site(prng.key(1234), i, STREAM_SITES, CHI, D,
                                     device=device)
            st.put(i, g, lam)
            del g, lam
    write_s = time.perf_counter() - tw
    disk = sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root))
    torch.cuda.empty_cache()
    print(f"stream: jiuzhang2 (M, χ, d) = ({STREAM_SITES}, {CHI}, {D}) "
          f"written as a bf16 GammaStore, {disk / 1e9:.3f} GB in "
          f"{write_s:.3f} s ({disk / write_s / 1e9:.3f} GB/s, the sites "
          f"drawn on the card); {STREAM_SITES * site * 8 / 1e9:.1f} GB "
          f"decoded to fp64", flush=True)
    return {"write_s": write_s, "disk_gb": disk / 1e9}


def _stream_decode(store, device) -> dict:
    """The card's read path against an independent decode: the sites of
    ``STREAM_DECODE`` drawn again on the card, rounded with ``bf16_bits``
    and upcast, equal bit for bit to what ``get_segment_on_device`` gives
    (pinned reads, the copy stream, the upcast on the card) at the full χ
    and cut on the host to the stage χ's 4096 and 256; Λ equal too."""
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import bf16_bits

    start, length = STREAM_DECODE
    want = []
    for i in range(start, start + length):
        g, lam = M.gbs_like_site(prng.key(1234), i, STREAM_SITES, CHI, D,
                                 device=device)
        want.append((bf16_bits(g).view(torch.bfloat16), lam))
        del g
    store.pin_memory = True
    cur = torch.cuda.current_stream(device)
    out = {}
    for chi in (None, STREAM_BUCKETS[2], STREAM_BUCKETS[0]):
        c = CHI if chi is None else chi
        seg = store.get_segment_on_device(start, length, device, chi=chi,
                                          prefetch_next_segment=False)
        cur.wait_event(seg["ready"])
        seg["gammas"].record_stream(cur)
        seg["lambdas"].record_stream(cur)
        check(seg["gammas"].shape == (length, c, c, D)
              and seg["gammas"].dtype == torch.float64,
              f"stream decode χ={c}: Γ {tuple(seg['gammas'].shape)} "
              f"{seg['gammas'].dtype}")
        bad = 0
        for j, (gb, lam) in enumerate(want):
            ref = gb[:c, :c, :].to(torch.float64).contiguous()
            bad += int((seg["gammas"][j].view(torch.int64)
                        != ref.view(torch.int64)).sum())
            bad += int((seg["lambdas"][j].view(torch.int64)
                        != lam[:c].contiguous().view(torch.int64)).sum())
        check(bad == 0, f"stream decode χ={c}: {bad} elements of Γ or Λ "
              "differ in their bits from the independent decode")
        out[str(c)] = {"elements": length * (c * c * D + c),
                       "bytes_copied": seg["bytes"], "differ": bad}
        del seg
    del want
    torch.cuda.empty_cache()
    print(f"stream decode: sites [{start}, {start + length}) through "
          f"get_segment_on_device == drawn again, bf16_bits and upcast, bit "
          f"for bit: {json.dumps(out)}", flush=True)
    return out


def _stream_flat(store, device) -> dict:
    """(a) The flat-χ streamed seq walk, N = 1024, segment length 2."""
    from repro_torch import api
    from repro_torch.core import perfmodel as PM
    from repro_torch.core import prng
    from repro_torch.engine import plan_stream
    from repro_torch.kernels import ops

    n, key = LINEAR_N, prng.key(21)
    w = PM.Workload(n, STREAM_SITES, CHI, D, macro_batch=n, micro_batch=n)
    planned = plan_stream(w, PM.H100, compute_bytes=8,
                          device_budget=STREAM_BUDGET).segment_len
    check(planned == 2, f"plan_stream chose {planned} sites a segment")
    cfg = api.SamplerConfig(backend="streamed", kernels="cuda",
                            device_budget=STREAM_BUDGET)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    # the main path: counts set to 0 just before, read just after
    ops.reset_launches()
    with api.SamplingSession(store, cfg, device=device) as session:
        plan = session.plan(n)
        samples = session.sample(n, key)
        stats = dict(session.stats)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) - base
    limit = (2 * 2 * CHI * CHI * D * 8 + 2 * 2 * CHI * CHI * D * 2
             + n * CHI * 8 + 2e9)
    io = _stream_io(stats)
    print(f"stream (a): seq walk N={n} M={STREAM_SITES} through the session "
          f"(segment_len {plan.segment_len}, {stats['segments']} segments) "
          f"in {io['wall_s']:.3f} s; launches {launches}; "
          f"max_live_segments {stats['max_live_segments']}; "
          f"max_memory_allocated {peak / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB before (limit {limit / 1e9:.3f}); "
          f"io {json.dumps(io)}", flush=True)
    check(plan.segment_len == 2, f"the session planned {plan.segment_len}")
    check(launches["site_step_linear"] == STREAM_SITES, "site_step_linear "
          f"launched {launches['site_step_linear']} times, expected "
          f"{STREAM_SITES}")
    check(stats["max_live_segments"] <= 2, "more than two live segments")
    check(peak <= limit, f"peak memory {peak / 1e9:.3f} GB beyond "
          f"{limit / 1e9:.3f}")
    check(samples.shape == (n, STREAM_SITES) and samples.min() >= 0
          and samples.max() < D, "stream (a): bad samples")
    kern = _engine_walk(store, device, n, key, "cuda")
    check(np.array_equal(kern[0], samples),
          "stream (a): session and engine walks differ")
    plain = _engine_walk(store, device, n, key, "torch")
    env_err, ls_err = _same_state("stream (a) kernel vs plain", kern, plain)
    print(f"stream (a): kernel walk == plain walk ({n * STREAM_SITES} "
          f"draws), env max abs diff {env_err:.3e}, log_scale max abs diff "
          f"{ls_err:.3e}; plain walk {plain[2]['wall_s']:.3f} s", flush=True)
    torch.cuda.empty_cache()
    return {"samples": samples, "launches": launches["site_step_linear"],
            "peak_gb": peak / 1e9, "limit_gb": limit / 1e9, "io": io,
            "env_err": env_err, "log_scale_err": ls_err,
            "plain_wall_s": plain[2]["wall_s"]}


def _stream_dyn(store, device) -> dict:
    """(b) Dyn-χ: the area-law profile of jiuzhang2 (asp 1.62) in buckets,
    streamed, against the same stage loop in memory over per-stage MPSs
    made site by site from the store, each site cut to its stage's χ on
    the host before it goes to the card.  The in-memory loop runs with
    the kernels and with the plain cells in lockstep, so kernel 1 is held
    against its plain version at each stage's χ (256, 1024, 4096, 10⁴) and
    after each pad or cut of the env."""
    from repro_torch.configs.gbs import JIUZHANG2
    from repro_torch.core import dynamic_bond as DB
    from repro_torch.core import prng
    from repro_torch.core import sampler as S
    from repro_torch.core.mps import MPS
    from repro_torch.kernels import ops

    n, key = LINEAR_N, prng.key(22)
    prof = DB.area_law_profile(STREAM_SITES, CHI, n_photon=JIUZHANG2.asp,
                               d=D)
    buck = DB.bucketize(prof, STREAM_BUCKETS)
    stages = [(st.start, st.stop, st.chi)
              for st in DB.stages_from_profile(buck)]
    check(stages == STREAM_STAGES, f"dyn-χ stages {stages}")
    table1 = DB.table1_metrics(prof, CHI)
    ops.reset_launches()
    streamed = _engine_walk(store, device, n, key, "cuda", chi_profile=buck)
    launches = ops.launch_counts()["site_step_linear"]
    check(launches == STREAM_SITES, f"dyn-χ: site_step_linear launched "
          f"{launches} times, expected {STREAM_SITES}")
    check(streamed[2]["max_live_segments"] <= 2, "more than two live "
          "segments")
    # in memory: the truncated decoded chain, stage by stage
    cur = torch.cuda.current_stream(device)
    parts, chain_bytes = [], 0
    for s0, s1, c in stages:
        g = torch.empty((s1 - s0, c, c, D), dtype=torch.float64,
                        device=device)
        lam = torch.empty((s1 - s0, c), dtype=torch.float64, device=device)
        for i in range(s0, s1):
            seg = store.get_segment_on_device(
                i, 1, device, chi=c if c < CHI else None)
            cur.wait_event(seg["ready"])
            seg["gammas"].record_stream(cur)
            g[i - s0].copy_(seg["gammas"][0])
            lam[i - s0].copy_(seg["lambdas"][0])
            del seg
        parts.append(MPS(g, lam))
        chain_bytes += g.numel() * 8
    # the kernel and the plain cells over the same stages, in lockstep:
    # each stage's χ (and the env padded or cut before it) held per stage
    cfgs = {k: S.SamplerConfig(kernels=k) for k in ("cuda", "torch")}
    states = {k: S.init_state(parts[0], n, key, cfg)
              for k, cfg in cfgs.items()}
    outs = {k: [] for k in cfgs}
    per_stage = []
    for (s0, _, c), part in zip(stages, parts):
        row = {"chi": c, "sites": part.n_sites}
        for k, cfg in cfgs.items():
            st = states[k]
            st = S.SamplerState(DB.fit_env(st.env, c), st.key, st.log_scale)
            ops.reset_launches()
            res = S.sample_chain(part, st, cfg, start_site=s0)
            if k == "cuda":
                row["launches"] = ops.launch_counts()["site_step_linear"]
            states[k] = res.state
            outs[k].append(res.samples)
        row["env_err"], row["log_scale_err"] = _same_walk(
            f"stream (b) stage [{s0}, {s0 + part.n_sites}) χ={c} kernel vs "
            f"plain", (outs["cuda"][-1], states["cuda"].env,
                       states["cuda"].log_scale),
            (outs["torch"][-1], states["torch"].env,
             states["torch"].log_scale))
        per_stage.append(row)
    torch.cuda.synchronize()
    inmem = {k: (torch.cat(outs[k]).T.cpu().numpy(), states[k])
             for k in cfgs}
    env_err, ls_err = _same_state("stream (b) dyn-χ streamed vs in memory",
                                  streamed, inmem["cuda"])
    plain_env_err, plain_ls_err = _same_state(
        "stream (b) dyn-χ streamed vs in memory, plain cells", streamed,
        inmem["torch"])
    for st in per_stage:
        check(st["launches"] == st["sites"], f"dyn-χ stage {st}")
    del parts, outs, states, inmem
    torch.cuda.empty_cache()
    print(f"stream (b): dyn-χ profile (area law, n_photon {JIUZHANG2.asp}) "
          f"in buckets {STREAM_BUCKETS}: stages {stages}; Table 1 "
          f"{json.dumps(table1)}; per stage χ and launches "
          f"{json.dumps(per_stage)}; streamed walk "
          f"{streamed[2]['wall_s']:.3f} s == in-memory staged walk on the "
          f"truncated chain ({chain_bytes / 1e9:.3f} GB fp64), env max abs "
          f"diff {env_err:.3e}, log_scale {ls_err:.3e}; == the plain cells' "
          f"in-memory staged walk, env max abs diff {plain_env_err:.3e}, "
          f"log_scale {plain_ls_err:.3e}; io "
          f"{json.dumps(_stream_io(streamed[2]))}", flush=True)
    return {"launches": launches, "stages": per_stage, "table1": table1,
            "chain_gb": chain_bytes / 1e9, "env_err": env_err,
            "log_scale_err": ls_err, "plain_env_err": plain_env_err,
            "plain_log_scale_err": plain_ls_err,
            "io": _stream_io(streamed[2])}


def _stream_resume(store, device, build, flat) -> dict:
    """(c) Walk (a) stopped after three segments, then resumed."""
    from repro_torch import api
    from repro_torch.core import prng

    n, key = LINEAR_N, prng.key(21)
    cfg = api.SamplerConfig(backend="streamed", kernels="cuda",
                            device_budget=STREAM_BUDGET)
    with tempfile.TemporaryDirectory(dir=build, prefix="ckpt_") as ck, \
            api.SamplingSession(store, cfg, device=device) as session:
        part = session.sample(n, key, checkpoint_dir=ck,
                              stop_after_segments=STREAM_STOP)
        resumed = session.sample(n, key, checkpoint_dir=ck, resume=True)
        segments = session.stats["segments"]
    check(np.array_equal(part, flat[:, :part.shape[1]])
          and part.shape[1] == 2 * STREAM_STOP,
          f"stream (c): the stopped walk's {part.shape[1]} sites differ")
    check(np.array_equal(resumed, flat),
          "stream (c): the resumed walk differs from the uninterrupted one")
    print(f"stream (c): stopped after {STREAM_STOP} segments "
          f"({part.shape[1]} sites), resumed with {segments} segments: "
          f"bit for bit the uninterrupted walk", flush=True)
    return {"stopped_sites": part.shape[1], "resumed_segments": segments}


def _stream_tp(root, device, mesh, build, registry) -> tuple:
    """(d) dp, tp_single (± measure_first) and tp_double streamed on the
    mesh over the first 4 sites, each against the in-memory walk of the
    same 4 decoded sites; then phase service's streamed parts on the
    first 2 of them (``service_streamed``), phase shard on the 4 and
    phase gateway on the 2.  Returns (walks, service, shard, gateway)."""
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import site_filename

    n, key = LINEAR_N, prng.key(11)
    walks = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="sub_") as sub, \
            tempfile.TemporaryDirectory(dir=build, prefix="svc_") as svc, \
            tempfile.TemporaryDirectory(dir=build, prefix="gloo_") as gloo:
        for i in range(STREAM_TP_SITES):
            os.symlink(os.path.join(root, site_filename(i)),
                       os.path.join(sub, site_filename(i)))
            if i < SERVICE_SITES:
                os.symlink(os.path.join(root, site_filename(i)),
                           os.path.join(svc, site_filename(i)))
        # the 2 gloo ranks of phases service (d) and shard (c, d), spawned
        # now: their start-up overlaps the walks below
        ranks = _gloo_spawn(sub, svc, gloo, n, device)
        try:
            service, shard, gateway = _stream_tp_walks(
                sub, svc, gloo, ranks, device, mesh, registry, n, key,
                walks)
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
    torch.cuda.empty_cache()
    return walks, service, shard, gateway


def _stream_tp_walks(sub, svc, gloo, ranks, device, mesh, registry, n, key,
                     walks) -> tuple[dict, dict, dict]:
    from repro_torch import api
    from repro_torch.core.mps import MPS
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.kernels import ops

    with GammaStore(sub, torch.bfloat16, torch.float64) as store:
        seg = store.get_segment_on_device(0, STREAM_TP_SITES, device)
        cur = torch.cuda.current_stream(device)
        cur.wait_event(seg["ready"])
        seg["gammas"].record_stream(cur)
        seg["lambdas"].record_stream(cur)
        mps = MPS(seg["gammas"], seg["lambdas"])
        del seg
        for (scheme, mf), kernels in TP_WALKS.items():
            label = scheme + ("+measure_first" if mf else "")
            cfg = api.SamplerConfig(backend="streamed", kernels="cuda",
                                    scheme=scheme, measure_first=mf,
                                    device_budget=STREAM_BUDGET)
            ops.reset_launches()
            with api.SamplingSession(store, cfg, mesh=mesh) as session:
                streamed = session.sample(n, key)
                stats = dict(session.stats)
            torch.cuda.synchronize()
            launches = {k: ops.launch_counts()[k] for k in kernels}
            for k in kernels:
                check(launches[k] == STREAM_TP_SITES, f"stream (d) "
                      f"{label}: {k} launched {launches[k]} times")
            with api.SamplingSession(mps, api.SamplerConfig(
                    kernels="cuda", scheme=scheme, measure_first=mf),
                    mesh=mesh) as session:
                inmem = session.sample(n, key)
            bad = int((streamed != inmem).sum())
            check(bad == 0, f"stream (d) {label}: streamed and in-memory "
                  f"walks differ in {bad} draws")
            walks[label] = {"launches": launches,
                            "segments": stats["segments"],
                            "max_live_segments":
                                stats["max_live_segments"],
                            "wall_s": stats["wall_s"]}
            print(f"stream (d) {label}: streamed walk N={n} "
                  f"M={STREAM_TP_SITES} == in-memory walk; "
                  f"{json.dumps(walks[label])}", flush=True)
        clamped = _stream_clamped(store, mps, mesh, n, key)
        clamped_seq = clamped["clamp seq"].pop("result")
        walks.update(clamped)
        del mps
    torch.cuda.empty_cache()
    service = service_streamed(svc, gloo, ranks, device, registry)
    shard = phase_shard(sub, gloo, ranks, device, clamped_seq)
    gateway = phase_gateway(svc, device)
    return service, shard, gateway


def _stream_clamped(store, mps, mesh, n, key) -> dict:
    """(f) Clamped seq and dp walks streamed from the 4-site sub-store
    against the in-memory clamped walk of the same decoded sites: samples
    equal, log_prob within TOL, ``contract_measure`` launched once a
    site."""
    from repro_torch import api
    from repro_torch.kernels import ops

    walks = {}
    for scheme in ("seq", "dp"):
        label = f"clamp {scheme}"
        cfg = dict(kernels="cuda", scheme=scheme, clamp=CLAMP_STREAM)
        ops.reset_launches()
        with api.SamplingSession(store, api.SamplerConfig(
                backend="streamed", device_budget=STREAM_BUDGET, **cfg),
                mesh=mesh) as session:
            streamed = session.sample(n, key)
            stats = dict(session.stats)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        check(launches == {"contract_measure": STREAM_TP_SITES},
              f"stream (f) {label}: launches {launches}")
        with api.SamplingSession(mps, api.SamplerConfig(**cfg),
                                 mesh=mesh) as session:
            inmem = session.sample(n, key)
            lp = session.stats["log_prob"]
        bad = int((streamed != inmem).sum())
        check(bad == 0, f"stream (f) {label}: streamed and in-memory walks "
              f"differ in {bad} draws")
        lp_err = float(np.abs(stats["log_prob"] - lp).max())
        check(np.allclose(stats["log_prob"], lp, **TOL[torch.float64])
              and np.isfinite(lp).all(),
              f"stream (f) {label}: log_prob differs (max abs {lp_err:.3e})")
        for site, v in CLAMP_STREAM.items():
            check(bool((streamed[:, site] == v).all()),
                  f"stream (f) {label}: site {site} is not clamped")
        walks[label] = {"launches": launches, "segments": stats["segments"],
                        "max_live_segments": stats["max_live_segments"],
                        "wall_s": stats["wall_s"], "log_prob_err": lp_err}
        print(f"stream (f) {label}: clamped streamed walk N={n} "
              f"M={STREAM_TP_SITES} == in-memory clamped walk; "
              f"{json.dumps(walks[label])}", flush=True)
        if scheme == "seq":               # phase shard (b)'s reference
            walks[label]["result"] = (streamed, stats["log_prob"])
    return walks


def _stream_timed(store, device, read_gbps) -> dict:
    """(e) One timed kernel walk at N₁ = min_macro_batch_for_overlap for the
    H100 preset with the read rate walk (a) measured, capped at 65,536."""
    import dataclasses

    from repro_torch import api
    from repro_torch.core import perfmodel as PM
    from repro_torch.core import prng

    hw = dataclasses.replace(PM.H100, io_bw=read_gbps * 1e9)
    w = PM.Workload(TIMED_N_CAP, STREAM_SITES, CHI, D)
    want = PM.min_macro_batch_for_overlap(w, hw, storage_bytes=2)
    n1 = min(want, TIMED_N_CAP)
    cfg = api.SamplerConfig(backend="streamed", kernels="cuda",
                            device_budget=TIMED_BUDGET,
                            hardware=hw)
    with api.SamplingSession(store, cfg, device=device) as session:
        plan = session.plan(n1)
        predicted = session.explain(n1)
        samples = session.sample(n1, prng.key(23))
        stats = dict(session.stats)
    torch.cuda.synchronize()
    check(samples.shape == (n1, STREAM_SITES) and samples.min() >= 0
          and samples.max() < D, "stream (e): bad samples")
    io = _stream_io(stats)
    io.update(n1=n1, n1_for_overlap=want, segment_len=plan.segment_len,
              predicted={k: predicted[k] for k in (
                  "t_compute_per_site_s", "t_io_per_site_s",
                  "io_overlapped", "min_macro_batch_for_overlap")},
              measured_compute_per_site_s=stats["compute_s"] / STREAM_SITES,
              measured_read_per_site_s=stats["store_io_s"] / STREAM_SITES)
    print(f"stream (e): timed walk N₁={n1} (the overlap macro batch at "
          f"{read_gbps:.3f} GB/s: {want}) M={STREAM_SITES}, segment_len "
          f"{plan.segment_len}: {json.dumps(io)}; {nvidia_smi()}",
          flush=True)
    torch.cuda.empty_cache()
    return io


def _segment(mesh, mps, n, key, scheme, measure_first, kernels):
    """The segment runner over the whole chain, a TP rank on its tiles
    (``parallel.rank_chain``): (samples, env, log_scale)."""
    from repro_torch.core import parallel as PP
    from repro_torch.core import sampler as S

    cfg = S.SamplerConfig(semantics=mps.semantics, kernels=kernels)
    pc = PP.ParallelConfig(scheme=scheme, measure_first=measure_first)
    env = PP.segment_env_init(n, mps.chi, mps.gammas.dtype, mps.device)
    return PP.sample_segment(mesh, PP.rank_chain(mesh, mps, pc), env, key, 0,
                             pc, cfg)


def _same_walk(name, got, want) -> tuple[float, float]:
    """Samples equal, env and log_scale within TOL; returns the largest env
    and log_scale differences."""
    bad = int((got[0] != want[0]).sum())
    check(bad == 0, f"{name}: samples differ in {bad} draws")
    tol = TOL[torch.float64]
    env_err = (got[1] - want[1]).abs().max().item()
    ls_err = (got[2] - want[2]).abs().max().item()
    check(torch.allclose(got[1], want[1], **tol),
          f"{name}: env differs (max abs {env_err:.3e})")
    check(torch.isfinite(got[2]).all().item()
          and torch.allclose(got[2], want[2], **tol),
          f"{name}: log_scale differs (max abs {ls_err:.3e})")
    return env_err, ls_err


def phase_tp(mesh, mps) -> dict:
    """The TP schemes through the session on the mesh, kernels vs plain.
    Returns, per walk, its launch counts and wall time."""
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n, key, sites = LINEAR_N, prng.key(11), mps.n_sites
    walks, first = {}, None
    for (scheme, mf), kernels in TP_WALKS.items():
        label = scheme + ("+measure_first" if mf else "")
        cfg = api.SamplerConfig(kernels="cuda", scheme=scheme,
                                measure_first=mf)
        # the main path: counts set to 0 just before, read just after
        ops.reset_launches()
        tw = time.perf_counter()
        with api.SamplingSession(mps, cfg, mesh=mesh) as session:
            samples = session.sample(n, key)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - tw
        launches = ops.launch_counts()
        for k in kernels:
            check(launches[k] == sites, f"{label}: {k} launched "
                  f"{launches[k]} times on the walk, expected {sites}")
        kern = _segment(mesh, mps, n, key, scheme, mf, "cuda")
        plain = _segment(mesh, mps, n, key, scheme, mf, "torch")
        torch.cuda.synchronize()
        check(np.array_equal(kern[0].T.cpu().numpy(), samples),
              f"{label}: session and segment walk differ")
        env_err, ls_err = _same_walk(label, kern, plain)
        first = samples if first is None else first
        check(np.array_equal(samples, first),
              f"{label}: samples differ from the dp walk's")
        walks[label] = {"launches": {k: launches[k] for k in kernels},
                        "walk_s": walk_s}
        print(f"tp {label}: session walk N={n} M={sites} in {walk_s:.3f} s; "
              f"launches {walks[label]['launches']}; kernel == plain "
              f"({n * sites} draws), env max abs diff {env_err:.3e}, "
              f"log_scale max abs diff {ls_err:.3e}", flush=True)
    _phase("tp", t0)
    return walks


# ---------------------------------------------------------------------------
# service: the job service, fleet workers and the broadcast plane
# ---------------------------------------------------------------------------

def _instrument(svc, registry) -> None:
    """Bind ``registry`` to a service (its counters are read in (e))."""
    from repro_torch.obs import instrument_service
    instrument_service(svc, registry)


def _io_share(stats) -> dict:
    """A walk's fetch (read or broadcast, checks, copies started),
    compute and overlap share (fetch + compute − wall) / min of the two."""
    fetch, comp, wall = stats["fetch_s"], stats["compute_s"], \
        stats["wall_s"]
    return {"wall_s": wall, "fetch_s": fetch, "compute_s": comp,
            "io_wait_s": stats["io_wait_s"],
            "overlap": ((fetch + comp - wall) / min(fetch, comp)
                        if min(fetch, comp) > 0 else None)}


def _broadcast_numbers(stats_by_proc: dict) -> dict:
    """(d)'s numbers from each process's walk stats: the bytes broadcast
    ((p − 1) × the segments' bytes), their rate over the root's broadcast
    seconds, the root's read rate, each process's compute seconds and
    overlap share."""
    root = stats_by_proc[0]
    p = len(stats_by_proc)
    check(root["broadcast_send_bytes"] >= (p - 1) * root["io_bytes"]
          and root["broadcast_send_bytes"] - (p - 1) * root["io_bytes"]
          < 2 ** 20 * root["broadcast_segments"],
          f"service (d): {root['broadcast_send_bytes']} bytes broadcast for "
          f"{p - 1} × {root['io_bytes']} bytes of segments")
    out = {"broadcast_bytes": root["broadcast_send_bytes"],
           "segment_bytes": root["io_bytes"],
           "broadcast_s": root["broadcast_s"],
           "broadcast_gbps": (root["broadcast_send_bytes"]
                              / root["broadcast_s"] / 1e9
                              if root["broadcast_s"] else None),
           "root_read_gb": root["io_bytes"] / 1e9,
           "root_read_gbps": (root["io_bytes"] / root["store_io_s"] / 1e9
                              if root["store_io_s"] else None),
           "processes": {}}
    for p, st in sorted(stats_by_proc.items()):
        out["processes"][str(p)] = dict(
            _io_share(st), broadcast_s=st["broadcast_s"],
            recv_bytes=st["broadcast_recv_bytes"], segments=st["segments"])
    return out


def service_streamed(svc, gloo, ranks, device, registry) -> dict:
    """Phase service's streamed parts, on the first 2 sites of phase
    stream's store (``svc``: bf16 on disk, fp64 walked, a site a segment),
    before the store is removed: (c) fleet lanes of worker processes on
    the card and the ``remote`` runtime; (d) the broadcast plane on an
    emulated 2-process cluster and on the 2 ``torch.distributed``
    processes (gloo) ``ranks``; each against the in-process streamed job of
    the same key, bit for bit."""
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore

    t0 = time.perf_counter()
    n, k, key = LINEAR_N, SERVICE_BATCHES, prng.key(SERVICE_SEED)
    cfg = api.SamplerConfig(backend="streamed", segment_len=SERVICE_SEGMENT)
    out = {}
    store = GammaStore(svc, torch.bfloat16, torch.float64)
    try:
        local = _service_streamed(store, device, registry, n, k, key, cfg,
                                  out)
    finally:
        store.close()
    torch.cuda.empty_cache()
    # (d) the broadcast plane: an emulated 2-process cluster on batch 1's
    # key, whose unclean stop the gloo job's batch 1 resumes from; then the
    # pipelined 2-batch gloo job
    out["emulated"] = _emulated_broadcast(svc, device, n, local[1], gloo)
    out["gloo"] = _gloo_broadcast(ranks, gloo, n, local)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"service (c, d) on {SERVICE_SITES} sites of the store in "
          f"{out['seconds']:.3f} s", flush=True)
    return out


def _service_streamed(store, device, registry, n, k, key, cfg, out) -> dict:
    """(c); returns the in-process job's blocks by batch."""
    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.kernels import ops

    # (c) fleet lanes: 2 worker processes on the card, spawned now so that
    # they start (interpreter, torch) while the in-process job runs; a
    # result dropped on batch 2 is a lane fault: the service kills that
    # worker, respawns it and recomputes the batch
    pool = api.WorkerPool()
    drop = _chaos_drop({2})
    pool.injectors.append(drop)
    fleet_svc = api.SamplingService(workers=0, pool=pool, straggler_k=None)
    _instrument(fleet_svc, registry)      # the spawns below are counted
    for _ in range(SERVICE_WORKERS):
        fleet_svc.add_worker()
    try:
        # the in-process streamed job (one thread lane): the reference
        ops.reset_launches()
        tw = time.perf_counter()
        with api.SamplingService(workers=1, device=device) as svc:
            h = svc.submit(store, cfg, n_samples=n * k, key=key,
                           macro_batches=k)
            local = dict(h.stream(timeout=600))
            local_stats = h.stats
        torch.cuda.synchronize()
        out["local"] = {"wall_s": time.perf_counter() - tw,
                        "launches": {x: v for x, v in
                                     ops.launch_counts().items() if v},
                        "walk_s": [local_stats[b]["wall_s"]
                                   for b in range(k)],
                        "io_hidden_frac": [local_stats[b]["io_hidden_frac"]
                                           for b in range(k)]}
        check(out["local"]["launches"] == {"site_step_linear":
                                           k * SERVICE_SITES},
              f"service (c): the in-process streamed job launched "
              f"{out['local']['launches']}")

        tw = time.perf_counter()
        h = fleet_svc.submit(store, cfg, n_samples=n * k, key=key,
                             macro_batches=k)
        arrivals, fleet = {}, {}
        for b, block in h.stream(timeout=900):
            arrivals[b] = time.perf_counter() - tw
            fleet[b] = block
        fleet_stats, st = h.stats, fleet_svc.stats()
        requeues = h.progress["requeues"]
    finally:
        fleet_svc.close()
        pool.close()
    for b in range(k):
        bad = int((fleet[b] != local[b]).sum())
        check(bad == 0, f"service (c): fleet block {b} differs from the "
              f"in-process job in {bad} draws")
    check(bool(drop.fired) and st["transport"]["lane_faults"] >= 1
          and st["transport"]["spawned"] >= SERVICE_WORKERS + 1
          and requeues >= 1,
          f"service (c): the dropped result did not requeue and respawn "
          f"({drop.fired}, {st['transport']}, {requeues} requeues)")
    worker_launches = {}
    for b in range(k):
        for x, v in fleet_stats[b]["launches"].items():
            worker_launches[x] = worker_launches.get(x, 0) + v
    check(all(fleet_stats[b]["launches"] == {"site_step_linear":
                                             SERVICE_SITES}
              for b in range(k)),
          f"service (c): worker launches per batch "
          f"{[fleet_stats[b]['launches'] for b in range(k)]}")
    walls = sorted(fleet_stats[b]["wall_s"] for b in range(k))
    out["fleet"] = {"first_result_s": min(arrivals.values()),
                    "warm_walk_s": walls[len(walls) // 2],
                    "walk_s": [fleet_stats[b]["wall_s"] for b in range(k)],
                    "job_wall_s": max(arrivals.values()),
                    "worker_launches": worker_launches,
                    "lane_faults": st["transport"]["lane_faults"],
                    "spawned": st["transport"]["spawned"],
                    "requeues": requeues,
                    "dropped": drop.fired,
                    "dispatch_bytes": st["transport"]["dispatch_bytes"]}
    print(f"service (c): fleet of {SERVICE_WORKERS} worker processes on the "
          f"card, {k} batches of N={n} streamed from {SERVICE_SITES} sites "
          f"of the store == the in-process job bit for "
          f"bit, after batch 2's result was dropped (its worker killed and "
          f"respawned, the batch requeued); {json.dumps(out['fleet'])}",
          flush=True)

    # the remote runtime: one persistent worker, the same payload twice
    key0 = batch_key(key, 0, k)
    rt = api.RemoteRuntime()
    with api.SamplingSession(store, api.SamplerConfig(
            runtime=rt, segment_len=SERVICE_SEGMENT),
            device=device) as session:
        tw = time.perf_counter()
        cold = session.sample(n, key0)
        cold_s = time.perf_counter() - tw
        tw = time.perf_counter()
        warm = session.sample(n, key0)
        warm_s = time.perf_counter() - tw
        launches = dict(rt.worker.launches)
        counters = rt.io_counters()
    rt.close()
    check(np.array_equal(cold, local[0]) and np.array_equal(warm, local[0]),
          "service (c): the remote runtime's walks differ from batch 0")
    check(launches == {"site_step_linear": 2 * SERVICE_SITES},
          f"service (c): the remote worker launched {launches}")
    out["remote"] = {"cold_s": cold_s, "warm_s": warm_s,
                     "worker_launches": launches,
                     "dispatch_bytes": counters["dispatch_bytes"]}
    print(f"service (c): remote runtime, one persistent worker: the payload "
          f"cold {cold_s:.3f} s (spawn, CUDA, kernels loaded, walk), again "
          f"warm {warm_s:.3f} s, both == batch 0; {json.dumps(out['remote'])}",
          flush=True)
    return local


def _chaos_drop(batch_ids):
    """A transport injector that drops the first result of a batch (a
    lane fault: the batch requeues and the worker respawns)."""
    class DropResult:
        def __init__(self):
            self.fired = []

        def after(self, worker, payload, result):
            b = (payload.get("job") or {}).get("batch_id")
            if b in batch_ids and not self.fired:
                self.fired.append((worker, b))
                return "drop"
            return None
    return DropResult()


def _drop_after(ckpt_dir: str, site: int) -> None:
    """What an unclean stop after ``site`` leaves of a multi-process walk's
    checkpoints (it keeps every boundary): the boundaries past it are gone
    (the sample blocks past it are written again by the resumed walk)."""
    for f in os.listdir(ckpt_dir):
        if f.startswith("site_") and f.endswith(".npz") and \
                int(f[len("site_"):-len(".npz")]) > site:
            os.remove(os.path.join(ckpt_dir, f))


def _gloo_checkpoints(gloo_dir: str) -> list:
    """Each gloo rank's checkpoint directory of the 2-batch job's batch 1
    (the job's ``checkpoint_root`` is ``ck<rank>``)."""
    from repro_torch.api.service import batch_checkpoint_dir
    return [batch_checkpoint_dir(os.path.join(gloo_dir, f"ck{r}"), 1)
            for r in range(2)]


def _emulated_broadcast(sub, device, n, want, gloo_dir) -> dict:
    """(d) on ``emulated_cluster(2)``: both members walk batch 1's key
    (checkpointing into the gloo ranks' batch-1 directories), == the
    local walk; then an unclean stop leaves member 0 at the chain's end and
    member 1 a segment before it (``STOP_CUTS``), and the resume walks the
    last segment only.  The same stop is left for the gloo job's batch
    1."""
    import threading

    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore

    key = batch_key(prng.key(SERVICE_SEED), 1, SERVICE_BATCHES)
    cks = _gloo_checkpoints(gloo_dir)
    members = api.emulated_cluster(2)

    def run(rt, results, resume=False):
        try:
            cfg = api.SamplerConfig(runtime=rt, backend="streamed",
                                    segment_len=SERVICE_SEGMENT,
                                    checkpoint_dir=cks[rt.process_index])
            with GammaStore(sub, torch.bfloat16, torch.float64) as st, \
                    api.SamplingSession(st, cfg, device=device) as s:
                got = s.sample(n, key, resume=resume)
                results[rt.process_index] = (got, dict(s.stats))
        except BaseException as e:   # noqa: BLE001 — checked below
            results[rt.process_index] = e

    def cluster(resume=False):
        results = {}
        threads = [threading.Thread(target=run, args=(rt, results, resume))
                   for rt in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for p, r in results.items():
            check(not isinstance(r, BaseException),
                  f"service (d) emulated: process {p} raised {r!r}")
        check(len(results) == 2, "service (d) emulated: a member hung")
        return results

    first = cluster()
    for ck, cut in zip(cks, STOP_CUTS):
        _drop_after(ck, cut)
    resumed = cluster(resume=True)
    for ck, cut in zip(cks, STOP_CUTS):
        _drop_after(ck, cut)              # the gloo job's batch 1 resumes
    for p in (0, 1):
        check(np.array_equal(first[p][0], want)
              and np.array_equal(resumed[p][0], want)
              and resumed[p][1]["segments"] == 1,
              f"service (d) emulated: process {p} differs from the local "
              f"walk, or resumed {resumed[p][1]['segments']} segments")
    out = _broadcast_numbers({p: first[p][1] for p in (0, 1)})
    out["resumed_segments"] = [resumed[p][1]["segments"] for p in (0, 1)]
    print(f"service (d) emulated_cluster(2): both members == the local "
          f"walk, and after an unclean stop (members at sites "
          f"{STOP_CUTS[0]} and {STOP_CUTS[1]}) the resume agreed on site "
          f"{min(STOP_CUTS)}; {json.dumps(out)}", flush=True)
    return out


def _gloo_spawn(sub, svc, gloo_dir, n, device):
    """Start the 2 gloo processes of phases service (d) and shard (c, d)
    (``torch.multiprocessing``, start method spawn: CUDA is initialised
    here); they wait for ``go``, then for ``go_shard``."""
    import torch.multiprocessing as mp

    return mp.start_processes(_gloo_rank,
                              args=(sub, svc, gloo_dir, n, str(device)),
                              nprocs=2, join=False, start_method="spawn")


def _wait_for(path: str, ranks, what: str, seconds: float = 900) -> None:
    """Wait for a file the gloo ranks write; fail when a rank has exited
    without it or the time is up."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        dead = [p.exitcode for p in ranks.processes
                if p.exitcode not in (None, 0)]
        check(not dead, f"{what}: a gloo process exited {dead}")
        check(time.monotonic() < deadline, f"{what}: no {path}")
        time.sleep(0.05)


def _gloo_rank(rank: int, sub: str, svc: str, gloo_dir: str, n: int,
               device: str) -> None:
    """One process of the ``torch.distributed`` job, both on ``device``:
    it joins a gloo group on a ``FileStore`` under ``gloo_dir`` with a
    ``TorchMultiHostRuntime``.  Phase service (d): once the parent writes
    ``go``, it runs the 2-batch job (keys of ``SERVICE_SEED``) on the
    store ``svc`` on a one-lane ``SamplingService`` with
    ``checkpoint_root=ck<rank>``: pipelined (batch 1's first segment is
    broadcast behind batch 0's walk), batch 1 resuming from the stop (d)'s
    emulated cluster left.  It writes its blocks, each batch's walk stats
    and its launches under ``gloo_dir``.  Phase shard: once the parent
    writes ``go_shard``, it runs (c) and (d) (``_gloo_shard``) on the
    4-site store ``sub``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.kernels import ops

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(gloo_dir, "filestore"), 2),
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=600))
    runtime = api.TorchMultiHostRuntime()
    rec = {"rank": rank, "device": str(device)}
    try:
        with GammaStore(svc, torch.bfloat16, torch.float64) as store, \
                api.SamplingSession(store, api.SamplerConfig(
                    backend="streamed", runtime=runtime,
                    segment_len=SERVICE_SEGMENT),
                    device=device) as session:
            while not os.path.exists(os.path.join(gloo_dir, "go")):
                time.sleep(0.05)
            ops.reset_launches()
            tw = time.perf_counter()
            with api.SamplingService(workers=1) as svc:
                h = svc.submit(session, n_samples=2 * n,
                               key=prng.key(SERVICE_SEED), macro_batches=2,
                               checkpoint_root=os.path.join(gloo_dir,
                                                            f"ck{rank}"))
                blocks = dict(h.stream(timeout=600))
                stats = h.stats
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rec["job_s"] = time.perf_counter() - tw
            rec["launches"] = {x: v for x, v in ops.launch_counts().items()
                               if v}
            rec["stats"] = {str(b): {x: v for x, v in st.items()
                                     if isinstance(v, (int, float))}
                            for b, st in stats.items()}
            # the job's totals: the warm fetch behind batch 0 belongs to
            # neither walk's stats
            rec["job"] = dict(runtime.io_counters(), io_bytes=store.io_bytes,
                              store_io_s=store.io_seconds)
            for b, blk in blocks.items():
                np.save(os.path.join(gloo_dir, f"rank{rank}_{b}.npy"), blk)
        with open(os.path.join(gloo_dir, f"rank{rank}.json.tmp"), "w") as f:
            json.dump(rec, f)
        os.replace(os.path.join(gloo_dir, f"rank{rank}.json.tmp"),
                   os.path.join(gloo_dir, f"rank{rank}.json"))
        while not os.path.exists(os.path.join(gloo_dir, "go_shard")):
            time.sleep(0.05)
        shard = _gloo_shard(rank, sub, gloo_dir, n, device, runtime)
        with open(os.path.join(gloo_dir, f"shard{rank}.json"), "w") as f:
            json.dump(shard, f)
        dist.barrier()                  # every rank is done with the groups
    finally:
        runtime.close()
        dist.destroy_process_group()


def _gloo_broadcast(ranks, gloo_dir, n, local) -> dict:
    """(d) on 2 gloo processes: let them go, wait, and hold their blocks
    against the in-process job's and their launches against the sites they
    walked (batch 0's, and batch 1's after the stop)."""
    open(os.path.join(gloo_dir, "go"), "w").close()
    tw = time.perf_counter()
    for r in range(2):
        _wait_for(os.path.join(gloo_dir, f"rank{r}.json"), ranks,
                  "service (d) gloo")
    wall = time.perf_counter() - tw
    recs = []
    for r in range(2):
        with open(os.path.join(gloo_dir, f"rank{r}.json")) as f:
            rec = json.load(f)
        recs.append(rec)
        for b in (0, 1):
            got = np.load(os.path.join(gloo_dir, f"rank{r}_{b}.npy"))
            check(np.array_equal(got, local[b]),
                  f"service (d) gloo: rank {r}'s batch {b} differs from the "
                  f"in-process job")
        resumed = rec["stats"]["1"]["segments"]
        want = {"site_step_linear": SERVICE_SITES
                + SERVICE_SEGMENT * resumed}
        check(resumed == 1 and rec["launches"] == want
              and rec["device"].startswith("cuda"),
              f"service (d) gloo: rank {r} on {rec['device']} resumed "
              f"{resumed} segments and launched {rec['launches']}")
    # bytes and rates over the job (batch 0's 2 segments, the warm one
    # batch 1 dropped, batch 1's last); fetch, compute and overlap of the
    # whole walk, batch 0
    out = _broadcast_numbers({r["rank"]: dict(r["stats"]["0"], **r["job"])
                              for r in recs})
    out.update(launches=[r["launches"] for r in recs], job_wall_s=wall,
               rank_job_s=[r["job_s"] for r in recs],
               resumed_segments=[r["stats"]["1"]["segments"] for r in recs],
               resumed_wall_s=[r["stats"]["1"]["wall_s"] for r in recs])
    print(f"service (d) torch.distributed, 2 processes on the card over "
          f"gloo: a pipelined 2-batch job, both ranks' blocks == the "
          f"in-process job's, batch 1 resumed from the stop at sites "
          f"{STOP_CUTS[0]} and {STOP_CUTS[1]}; {json.dumps(out)}",
          flush=True)
    return out


def _flip_bytes(path: str, n: int = 8) -> None:
    """Rot a file: invert ``n`` bytes in its middle."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.seek(f.tell() // 2)
        chunk = f.read(n)
        f.seek(-len(chunk), os.SEEK_CUR)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _gloo_shard(rank: int, sub: str, gloo_dir: str, n: int, device,
                runtime) -> dict:
    """Phase shard in a gloo rank.  (c) The sharded 2-batch job (keys of
    ``SHARD_SEED``) on a one-lane service, pipelined (batch 1's first owned
    segment is read behind batch 0's walk), on the shared 4-site store: a
    site a block, so this rank walks and reads 2 sites a batch and hands
    the env on at 3 boundaries.  (d) The same walk on batch 0's key from
    the roots of ``shard_roots.json``: rank 0's slice holds a rotted copy
    of site ``SHARD_ROT[0]``, which the pre-walk round writes again from
    rank 1's; then rank 1 rots its own copy of ``SHARD_ROT[1]``, which no
    peer holds, and both ranks must fail that round."""
    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore, site_filename
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import CorruptSegment
    from repro_torch.shard import ShardMap, ShardedGammaStore

    def numbers(st):
        return {x: v for x, v in st.items() if isinstance(v, (int, float))
                and not isinstance(v, bool)}

    rec = {"rank": rank}
    cfg = api.SamplerConfig(backend="streamed", runtime=runtime,
                            segment_len=1, shard="auto")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    with GammaStore(sub, torch.bfloat16, torch.float64) as store, \
            api.SamplingSession(store, cfg, device=device) as session:
        ops.reset_launches()
        tw = time.perf_counter()
        with api.SamplingService(workers=1) as svc:
            h = svc.submit(session, n_samples=2 * n,
                           key=prng.key(SHARD_SEED), macro_batches=2)
            blocks = dict(h.stream(timeout=600))
            stats = h.stats
        if on_card:
            torch.cuda.synchronize(device)
        rec["job_s"] = time.perf_counter() - tw
        rec["launches"] = {x: v for x, v in ops.launch_counts().items() if v}
        rec["stats"] = {str(b): numbers(st) for b, st in stats.items()}
        view = next(iter(session._engines.values())).store  # the owned view
        rec["reads"] = {"payload_reads": view.payload_reads,
                        "io_bytes": view.io_bytes,
                        "read_s": view.io_seconds}
        if on_card:
            rec["peak_gb"] = (torch.cuda.max_memory_allocated(device)
                              - base) / 1e9
        for b, blk in blocks.items():
            np.save(os.path.join(gloo_dir, f"shard_rank{rank}_{b}.npy"), blk)

    with open(os.path.join(gloo_dir, "shard_roots.json")) as f:
        roots = json.load(f)
    sm = ShardMap(STREAM_TP_SITES, 2, 1)
    key0 = batch_key(prng.key(SHARD_SEED), 0, 2)

    def walk():
        src = (ShardedGammaStore(roots["host0"], sm, 0, torch.bfloat16,
                                 torch.float64) if rank == 0 else
               GammaStore(roots["host1"], torch.bfloat16, torch.float64))
        with src, api.SamplingSession(src, cfg, device=device) as s:
            ops.reset_launches()
            tw = time.perf_counter()
            got = s.sample(n, key0)
            return got, dict(numbers(s.stats),
                             job_s=time.perf_counter() - tw,
                             launches={x: v for x, v in
                                       ops.launch_counts().items() if v})

    got, rec["repair"] = walk()
    np.save(os.path.join(gloo_dir, f"repair_rank{rank}.npy"), got)
    if rank == 1:
        path = os.path.join(roots["host1"], site_filename(SHARD_ROT[1]))
        real = os.path.realpath(path)
        os.remove(path)
        shutil.copyfile(real, path)
        _flip_bytes(path)
    runtime.barrier()
    try:
        walk()
        rec["unrepairable"] = {"error": None}
    except CorruptSegment as e:
        rec["unrepairable"] = {"error": type(e).__name__,
                               "kind": e.fault.kind, "site": e.fault.site,
                               "message": e.fault.message}
    return rec


def _shard_emulated(sub, device, hosts, n, key, want, site_bytes,
                    clamp=None) -> dict:
    """(a) / (b): one sharded walk (a site a block) on
    ``emulated_cluster(hosts)``, a session per member in its own thread,
    against ``want`` (samples, or samples and log_prob)."""
    import threading

    from repro_torch import api
    from repro_torch.core.perfmodel import Workload, shard_wire_bytes
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.kernels import ops
    from repro_torch.shard import ShardMap, chain_segments

    label = f"shard ({'b' if clamp else 'a'}) emulated_cluster({hosts})"
    members = api.emulated_cluster(hosts, timeout=600)
    results = {}

    def run(rt):
        try:
            cfg = api.SamplerConfig(runtime=rt, backend="streamed",
                                    segment_len=1, shard="auto", clamp=clamp)
            with GammaStore(sub, torch.bfloat16, torch.float64) as st, \
                    api.SamplingSession(st, cfg, device=device) as s:
                results[rt.process_index] = (s.sample(n, key),
                                             dict(s.stats))
        except BaseException as e:   # noqa: BLE001 — checked below
            results[rt.process_index] = e

    ops.reset_launches()
    tw = time.perf_counter()
    threads = [threading.Thread(target=run, args=(rt,)) for rt in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    launches = {x: v for x, v in ops.launch_counts().items() if v}
    check(len(results) == hosts, f"{label}: a member hung")
    for p, r in results.items():
        check(not isinstance(r, BaseException),
              f"{label}: process {p} raised {r!r}")
    sm = ShardMap(STREAM_TP_SITES, hosts, 1)
    handoffs = sm.handoffs(chain_segments(STREAM_TP_SITES, 1))
    wire = shard_wire_bytes(Workload(n_samples=n, n_sites=STREAM_TP_SITES,
                                     chi=CHI, d=D), hosts, block=1)
    # a handoff's payload: env (wire's handoff_bytes), log_scale (fp64),
    # the key's two uint32 words and the boundary site; log_prob if clamped
    extra = n * 8 + 16 + (n * 8 if clamp else 0)
    kernel = "contract_measure" if clamp else "site_step_linear"
    check(launches == {kernel: STREAM_TP_SITES},
          f"{label}: launches {launches}, expected {kernel} × "
          f"{STREAM_TP_SITES}")
    sent = sum(r[1]["handoff_send_bytes"] for r in results.values())
    check(sent == wire["handoff_bytes"] + len(handoffs) * extra,
          f"{label}: {sent} handoff bytes sent, the model's "
          f"{wire['handoff_bytes']} env bytes + {len(handoffs)} × {extra}")
    want_samples = want[0] if clamp else want
    hosts_out = {}
    for p, (got, st) in sorted(results.items()):
        owned = sm.owned_sites(p)
        check(np.array_equal(got, want_samples),
              f"{label}: process {p}'s samples differ from the local walk")
        check(st["io_bytes"] == site_bytes * len(owned)
              and st["segments"] == len(owned)
              and st["owned_segments"] == len(owned),
              f"{label}: process {p} read {st['io_bytes']} bytes in "
              f"{st['segments']} segments, owning sites {owned}")
        check(st["handoffs"] == sum(p in (a, b) for _, a, b in handoffs)
              and st["broadcast_recv_bytes"] == 0
              and st["broadcast_send_bytes"] == 0,
              f"{label}: process {p}: {st['handoffs']} handoffs, "
              f"broadcast {st['broadcast_recv_bytes']} bytes")
        if clamp:
            err = float(np.abs(st["log_prob"] - want[1]).max())
            check(np.allclose(st["log_prob"], want[1], **TOL[torch.float64]),
                  f"{label}: process {p}'s log_prob differs ({err:.3e})")
            for site, v in clamp.items():
                check(bool((got[:, site] == v).all()),
                      f"{label}: site {site} is not clamped")
        hosts_out[str(p)] = {
            "owned_sites": owned, "wall_s": st["wall_s"],
            "read_s": st["store_io_s"], "read_gb": st["io_bytes"] / 1e9,
            "compute_s": st["compute_s"], "handoffs": st["handoffs"],
            "handoff_send_bytes": st["handoff_send_bytes"],
            "handoff_send_s": st["handoff_send_s"],
            "handoff_wait_s": st["handoff_wait_s"],
            "handoff_copy_s": st["handoff_copy_s"],
            "gather_bytes": st["gather_bytes"]}
    out = {"wall_s": wall, "launches": launches, "handoff_bytes": sent,
           "model": wire, "hosts": hosts_out}
    print(f"{label}: every process == the local walk, each read only its "
          f"sites; {json.dumps(out)}", flush=True)
    return out


def _shard_roots(sub, gloo) -> dict:
    """(d)'s roots: host 0's slice (``materialize_shard``: its sites hard-
    linked, the manifest) with site ``SHARD_ROT[0]`` a rotted copy, and
    host 1's root holding every site (links to the store) and the
    manifest."""
    from repro_torch.data.gamma_store import MANIFEST_NAME, site_filename
    from repro_torch.shard import ShardMap, materialize_shard

    sm = ShardMap(STREAM_TP_SITES, 2, 1)
    host0 = materialize_shard(sub, os.path.join(gloo, "host0"), sm, 0)
    host1 = os.path.join(gloo, "host1")
    os.makedirs(host1)
    for i in range(STREAM_TP_SITES):
        os.symlink(os.path.realpath(os.path.join(sub, site_filename(i))),
                   os.path.join(host1, site_filename(i)))
    shutil.copyfile(os.path.join(host0, MANIFEST_NAME),
                    os.path.join(host1, MANIFEST_NAME))
    # a hard link shares the store's file: copy it, then rot the copy
    path = os.path.join(host0, site_filename(SHARD_ROT[0]))
    os.remove(path)
    shutil.copyfile(os.path.realpath(os.path.join(
        sub, site_filename(SHARD_ROT[0]))), path)
    _flip_bytes(path)
    roots = {"host0": host0, "host1": host1}
    with open(os.path.join(gloo, "shard_roots.json"), "w") as f:
        json.dump(roots, f)
    return roots


def phase_shard(sub, gloo, ranks, device, clamped_seq) -> dict:
    """The sharded data plane on phase stream's 4-site sub-store (3.2 GB
    bf16, fp64 walked, a site a segment and a block, N = 1024): (a)
    ``shard="auto"`` on ``emulated_cluster(2)`` and ``(4)``; (b) the
    clamped walk (stream (f)'s clamp) on ``emulated_cluster(2)``; (c) a
    pipelined 2-batch service job on the 2 gloo processes; (d) peer repair
    on them, then an unrepairable site.  Each process's samples equal the
    local walk's bit for bit."""
    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore

    t0 = time.perf_counter()
    n = LINEAR_N
    keys = [batch_key(prng.key(SHARD_SEED), b, 2) for b in (0, 1)]
    local, lstats = [], []
    with GammaStore(sub, torch.bfloat16, torch.float64) as store, \
            api.SamplingSession(store, api.SamplerConfig(
                backend="streamed", segment_len=1), device=device) as s:
        for k in keys:
            local.append(s.sample(n, k))
            lstats.append(dict(s.stats))
    site_bytes = lstats[0]["io_bytes"] // STREAM_TP_SITES
    out = {"local": [{"wall_s": st["wall_s"], "read_s": st["store_io_s"],
                      "compute_s": st["compute_s"]} for st in lstats]}
    for hosts in SHARD_HOSTS:
        out[f"emulated_{hosts}"] = _shard_emulated(
            sub, device, hosts, n, keys[0], local[0], site_bytes)
    out["clamped"] = _shard_emulated(sub, device, 2, n, prng.key(11),
                                     clamped_seq, site_bytes,
                                     clamp=CLAMP_STREAM)
    torch.cuda.empty_cache()

    tr = time.perf_counter()
    _shard_roots(sub, gloo)
    out["roots_s"] = time.perf_counter() - tr
    open(os.path.join(gloo, "go_shard"), "w").close()
    tw = time.perf_counter()
    for r in range(2):
        _wait_for(os.path.join(gloo, f"shard{r}.json"), ranks,
                  "shard (c, d) gloo")
    out["gloo_wall_s"] = time.perf_counter() - tw
    deadline = time.monotonic() + 120
    while not ranks.join(timeout=max(1.0, deadline - time.monotonic())):
        check(time.monotonic() < deadline, "shard: a gloo process did not "
              "finish")
    recs = []
    for r in range(2):
        with open(os.path.join(gloo, f"shard{r}.json")) as f:
            recs.append(json.load(f))
    gloo_out = {}
    for r, rec in enumerate(recs):
        for b in (0, 1):
            got = np.load(os.path.join(gloo, f"shard_rank{r}_{b}.npy"))
            check(np.array_equal(got, local[b]), f"shard (c) gloo: rank "
                  f"{r}'s batch {b} differs from the local walk")
        reads = rec["reads"]
        check(rec["launches"] == {"site_step_linear": 4}
              and reads["payload_reads"] == 4
              and reads["io_bytes"] == 4 * site_bytes,
              f"shard (c) gloo: rank {r} launched {rec['launches']} and "
              f"read {reads}, expected 2 owned sites a batch")
        per = {}
        for b, st in rec["stats"].items():
            per[b] = {x: st[x] for x in (
                "wall_s", "store_io_s", "io_bytes", "compute_s",
                "handoffs", "handoff_send_bytes", "handoff_recv_bytes",
                "handoff_send_s", "handoff_wait_s", "handoff_copy_s",
                "gather_s", "gather_bytes", "io_wait_s")}
            sent = st["handoff_send_bytes"]
            per[b]["handoff_gbps"] = (sent / st["handoff_send_s"] / 1e9
                                      if st["handoff_send_s"] else None)
        gloo_out[str(r)] = {"job_s": rec["job_s"], "batches": per,
                            "read_gb": reads["io_bytes"] / 1e9,
                            "read_gbps": (reads["io_bytes"]
                                          / reads["read_s"] / 1e9),
                            "peak_gb": rec.get("peak_gb"),
                            "launches": rec["launches"]}
    out["gloo"] = gloo_out
    print(f"shard (c) torch.distributed, 2 processes on the card over gloo: "
          f"a pipelined 2-batch sharded job, both ranks' blocks == the local "
          f"walks, each rank reading its 2 sites a batch "
          f"({2 * site_bytes / 1e9:.3f} GB); {json.dumps(gloo_out)}",
          flush=True)

    rep = [rec["repair"] for rec in recs]
    for r in range(2):
        got = np.load(os.path.join(gloo, f"repair_rank{r}.npy"))
        check(np.array_equal(got, local[0]), f"shard (d): rank {r}'s "
              f"repaired walk differs from the local walk")
    check(rep[0]["repaired_sites"] == 1 and rep[1]["repaired_sites"] == 0
          and rep[0]["quarantined_sites"] == 1,
          f"shard (d): repaired {[x['repaired_sites'] for x in rep]}, "
          f"quarantined {[x['quarantined_sites'] for x in rep]}")
    bad = [rec["unrepairable"] for rec in recs]
    for r, u in enumerate(bad):
        check(u["error"] == "CorruptSegment" and u["kind"] == "corruption"
              and u["site"] == SHARD_ROT[1]
              and "no peer holds a healthy copy" in u["message"],
              f"shard (d): rank {r} on the unrepairable site: {u}")
    out["repair"] = {str(r): {x: rep[r][x] for x in (
        "job_s", "wall_s", "repaired_sites", "quarantined_sites",
        "store_io_s", "io_bytes", "compute_s")} for r in range(2)}
    out["repair_launches"] = [x["launches"] for x in rep]
    out["unrepairable"] = bad
    print(f"shard (d): rank 0's rotted copy of site {SHARD_ROT[0]} written "
          f"again from rank 1's before the walk (repaired 1 / 0), the "
          f"samples == the local walk; a rotted site no peer holds (site "
          f"{SHARD_ROT[1]}) failed both ranks with kind=corruption; "
          f"{json.dumps(out['repair'])}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    _phase("shard", t0)
    return out


class _GatewayClient:
    """A real-socket client of the gateway: JSON requests and the chunked
    frame stream."""

    def __init__(self, url: str, api_key=None):
        import http.client
        host, port = url.removeprefix("http://").split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=600)
        self.api_key = api_key

    def _headers(self) -> dict:
        return {"x-api-key": self.api_key} if self.api_key else {}

    def request(self, method, path, body=None):
        self.conn.request(method, path, None if body is None
                          else json.dumps(body), self._headers())
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), \
            json.loads(resp.read() or b"{}")

    def submit(self, store, seed, config):
        return self.request("POST", "/v1/jobs", {
            "store": store, "n_samples": GATEWAY_N, "seed": seed,
            "macro_batches": 2, "config": config})

    def stream_frames(self, gid):
        """[npy frame bytes, ...] and the terminal header."""
        from repro_torch.runtime import transport

        class Exact:
            def __init__(self, resp):
                self.resp = resp

            def read(self, n):
                buf = b""
                while len(buf) < n:
                    chunk = self.resp.read(n - len(buf))
                    if not chunk:
                        break
                    buf += chunk
                return buf

        self.conn.request("GET", f"/v1/jobs/{gid}/stream", None,
                          self._headers())
        resp = self.conn.getresponse()
        check(resp.status == 200, f"gateway: stream {gid} answered "
              f"{resp.status}")
        rx, frames, terminal = Exact(resp), [], None
        while terminal is None:
            head = json.loads(transport.read_frame(rx))
            if head["kind"] == "block":
                frames.append(transport.read_frame(rx))
            else:
                terminal = head
        resp.read()
        return frames, terminal

    def close(self) -> None:
        self.conn.close()


def phase_gateway(svc, device) -> dict:
    """The serving stack on the first 2 sites of phase stream's store, at
    the jiuzhang2 width: an in-process ``Gateway`` over a one-lane
    ``SamplingService`` on the card, 2 tenants, a disk ``ResultCache``
    under ``build/``; a real-socket client.  A job of N = 1024 in 2 batches
    (the store opened as the gateway opens it: fp32 walked) == the
    session's walks of the same batches; the same request again is a hit
    (byte-identical frames, no execution, no launch); an identical request
    attaches; a tenant over its quota gets 429 with Retry-After; another
    tenant's GET answers 404; the owner's DELETE of a running job streams
    the error frame; ``/metrics`` shows the gateway's and the service's
    counters.  The store's 2 sites are hard-linked under ``build/`` for
    phase cli's launcher run."""
    import threading

    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import site_filename
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, instrument_service
    from repro_torch.runtime import transport
    from repro_torch.serve import Gateway, ResultCache, Tenant, TenantTable

    t0 = time.perf_counter()
    build = ROOT / "build"
    root = tempfile.mkdtemp(dir=build, prefix="gateway_stores_")
    name = "jiuzhang2_2sites"
    os.makedirs(os.path.join(root, name))
    for i in range(SERVICE_SITES):
        os.link(os.path.realpath(os.path.join(svc, site_filename(i))),
                os.path.join(root, name, site_filename(i)))
    config = {"segment_len": 1}
    k = 2
    with api.SamplingSession(os.path.join(root, name), api.SamplerConfig(
            segment_len=1), device=device) as s:
        want = [s.sample(GATEWAY_N // k, batch_key(prng.key(GATEWAY_SEED), b,
                                                   k)) for b in range(k)]
    out = {"store_root": root, "name": name,
           "samples": np.concatenate(want, axis=0)}
    registry = MetricsRegistry()
    tenants = TenantTable([Tenant(name=t, api_key=key, max_active_jobs=m)
                           for t, key, m in GATEWAY_TENANTS])
    cache_dir = tempfile.mkdtemp(dir=build, prefix="gateway_cache_")
    try:
        with api.SamplingService(workers=1) as service:
            instrument_service(service, registry)
            with Gateway(service, tenants=tenants,
                         cache=ResultCache(cache_dir=cache_dir),
                         registry=registry, store_root=root) as gw:
                alice = _GatewayClient(gw.url, "alice-key")
                bob = _GatewayClient(gw.url, "bob-key")
                ops.reset_launches()
                tw = time.perf_counter()
                code, _, first = alice.submit(name, GATEWAY_SEED, config)
                frames, term = alice.stream_frames(first["id"])
                torch.cuda.synchronize()
                out["miss_s"] = time.perf_counter() - tw
                launches = {x: v for x, v in ops.launch_counts().items()
                            if v}
                check(code == 201 and first["cache"] == "miss"
                      and term["kind"] == "end",
                      f"gateway: first request {code} {first} {term}")
                check(launches == {"site_step_linear": k * SERVICE_SITES},
                      f"gateway: the job launched {launches}")
                check(frames == [transport.array_to_frame(w) for w in want],
                      "gateway: the streamed frames differ from the "
                      "session's walks of the same batches")
                done = service.stats()["jobs"]["done"]
                ops.reset_launches()
                tw = time.perf_counter()
                code, _, hit = alice.submit(name, GATEWAY_SEED, config)
                frames2, _ = alice.stream_frames(hit["id"])
                out["hit_s"] = time.perf_counter() - tw
                check(code == 201 and hit["cache"] == "hit"
                      and frames2 == frames
                      and service.stats()["jobs"]["done"] == done
                      and not any(ops.launch_counts().values()),
                      f"gateway: the repeat was {hit['cache']}, its frames "
                      f"{'equal' if frames2 == frames else 'differ'}, "
                      f"launches {ops.launch_counts()}")

                # held batches: an attach, bob's own job, his quota, a
                # foreign GET, the owner's DELETE of a running job
                gates = {}

                def hold(job, b, w):
                    gates.setdefault(job.job_id, threading.Event()).wait(
                        timeout=300)
                service.batch_hook = hold

                def job_of(gid):
                    return gw._records[gid].handle.job_id

                def release(gid):
                    gates.setdefault(job_of(gid), threading.Event()).set()
                try:
                    _, _, a = alice.submit(name, GATEWAY_SEED + 1, config)
                    _, _, b = bob.submit(name, GATEWAY_SEED + 1, config)
                    _, _, c = bob.submit(name, GATEWAY_SEED + 2, config)
                    code_q, headers, _ = bob.submit(name, GATEWAY_SEED + 3,
                                                    config)
                    code_f, _, _ = bob.request("GET", f"/v1/jobs/{a['id']}")
                    release(a["id"])
                    deadline = time.monotonic() + 300
                    while bob.request("GET", f"/v1/jobs/{c['id']}")[2][
                            "state"] != "running":
                        check(time.monotonic() < deadline,
                              "gateway: bob's job never ran")
                        time.sleep(0.02)
                    code_d, _, dele = bob.request("DELETE",
                                                  f"/v1/jobs/{c['id']}")
                finally:
                    service.batch_hook = None
                    for e in list(gates.values()):
                        e.set()
                a_frames, a_term = alice.stream_frames(a["id"])
                b_frames, b_term = bob.stream_frames(b["id"])
                _, c_term = bob.stream_frames(c["id"])
                check((a["cache"], b["cache"], c["cache"])
                      == ("miss", "attach", "miss")
                      and a_term["kind"] == b_term["kind"] == "end"
                      and a_frames == b_frames,
                      f"gateway: attach {a['cache']}/{b['cache']}, "
                      f"{a_term} {b_term}")
                check(code_q == 429 and int(headers["Retry-After"]) >= 1,
                      f"gateway: bob over his quota got {code_q}")
                check(code_f == 404, f"gateway: bob's GET of alice's job "
                      f"got {code_f}")
                check(code_d == 200 and dele["cancelled"] is True
                      and c_term["kind"] == "error",
                      f"gateway: bob's DELETE {code_d} {dele}, then "
                      f"{c_term}")
                alice.conn.request("GET", "/metrics")
                text = alice.conn.getresponse().read().decode()
                values = {ln.split(" ")[0]: float(ln.split(" ")[-1])
                          for ln in text.splitlines()
                          if ln and not ln.startswith("#")}
                shown = {x: values.get(x) for x in (
                    'fastmps_http_requests_total{route="submit",code="429"}',
                    'fastmps_cache_events_total{event="hit"}',
                    'fastmps_cache_events_total{event="attach"}',
                    'fastmps_cache_events_total{event="miss"}',
                    "fastmps_tenant_rejections_total",
                    "fastmps_jobs_submitted_total",
                    "fastmps_batches_total")}
                check(shown['fastmps_http_requests_total{route="submit",'
                            'code="429"}'] == 1
                      and shown['fastmps_cache_events_total{event="hit"}']
                      == 1 and shown["fastmps_jobs_submitted_total"] == 3
                      and shown["fastmps_tenant_rejections_total"] == 1
                      and (shown["fastmps_batches_total"] or 0) >= 4,
                      f"gateway: /metrics shows {shown}")
                out["metrics"] = shown
                out["stats"] = {x: gw.stats()["cache"][x] for x in (
                    "hits", "misses", "attaches", "disk_entries",
                    "disk_bytes")}
                for cl in (alice, bob):
                    cl.close()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"gateway: N={GATEWAY_N} in 2 batches over {SERVICE_SITES} sites "
          f"== the session's walks; the repeat a hit (same bytes, no "
          f"execution, no launch); attach, 429, 404 and the owner's "
          f"cancel held; {json.dumps({x: v for x, v in out.items() if x != 'samples'})}",
          flush=True)
    _phase("gateway", t0)
    return out


def phase_service(mps, streamed, registry) -> dict:
    """The job service on phase 4's chain (jiuzhang2 width, fp64, M = 8,
    N = 1024 a batch): (a) ``session.sample`` through its one-lane
    service == the direct core walk, its added wall time; (b) a 4-batch
    job on 1 and on 2 thread lanes == the one-shot walks on the batch
    keys, a lane removed mid-job, a clamped 2-batch job; (e) the metrics
    registry's counters over (b) and (c)."""
    from repro_torch import api
    from repro_torch.api.service import batch_key
    from repro_torch.core import prng
    from repro_torch.core import sampler as S
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n, sites, key = LINEAR_N, mps.n_sites, prng.key(7)
    out = {"streamed": streamed}
    cfg = api.SamplerConfig(kernels="cuda")

    # (a) one job on the session's one-lane service vs the direct walk
    with api.SamplingSession(mps, cfg, device=mps.device) as session:
        ops.reset_launches()
        got = session.sample(n, key)
        torch.cuda.synchronize()
        launches = {x: v for x, v in ops.launch_counts().items() if v}
        direct = S.sample(mps, n, key, S.SamplerConfig(kernels="cuda"))
        check(np.array_equal(got, direct.cpu().numpy())
              and launches == {"site_step_linear": sites},
              f"service (a): the service's walk differs from the direct "
              f"walk, or launched {launches}")
        via, plain = [], []
        for _ in range(3):
            tw = time.perf_counter()
            session.sample(n, key)
            torch.cuda.synchronize()
            via.append(time.perf_counter() - tw)
            tw = time.perf_counter()
            S.sample(mps, n, key, S.SamplerConfig(kernels="cuda"))
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - tw)
    walk_s, via_s = statistics.median(plain), statistics.median(via)
    out["a"] = {"walk_s": walk_s, "service_walk_s": via_s,
                "added_s": via_s - walk_s, "launches": launches}
    print(f"service (a): session.sample through the one-lane service == the "
          f"direct walk ({launches}); the walk {walk_s * 1e3:.3f} ms, "
          f"through the service {via_s * 1e3:.3f} ms: "
          f"{(via_s - walk_s) * 1e3:.3f} ms added per job", flush=True)

    # (b) 4 batches on 1 and 2 thread lanes
    k = SERVICE_BATCHES
    with api.SamplingSession(mps, cfg, device=mps.device) as session:
        refs = [session.sample(n, batch_key(key, b, k)) for b in range(k)]
    lanes = {}
    # no straggler reclaim in (b): a duplicated batch would launch its
    # kernels twice, and the launch counts are held exactly
    for workers in (1, SERVICE_LANES):
        with api.SamplingService(workers=workers, straggler_k=None,
                                 device=mps.device) as svc:
            if workers > 1:
                _instrument(svc, registry)
            svc.submit(mps, cfg, n_samples=n, key=key).result(timeout=600)
            ops.reset_launches()
            tw = time.perf_counter()
            h = svc.submit(mps, cfg, n_samples=n * k, key=key,
                           macro_batches=k)
            blocks = dict(h.stream(timeout=600))
            torch.cuda.synchronize()
            wall = time.perf_counter() - tw
            launches = {x: v for x, v in ops.launch_counts().items() if v}
            st = svc.stats()
        for b in range(k):
            check(np.array_equal(blocks[b], refs[b]),
                  f"service (b): block {b} on {workers} lane(s) differs "
                  f"from sample(N, fold_in(key, {b}))")
        check(launches == {"site_step_linear": k * sites},
              f"service (b): {workers} lane(s) launched {launches}")
        lanes[str(workers)] = {"wall_s": wall,
                               "samples_per_s": n * k / wall,
                               "launches": launches,
                               "lane_batches": st["lane_batches"]}
    # a lane removed mid-job: its batch requeues, the result is the same
    with api.SamplingService(workers=SERVICE_LANES, straggler_k=None,
                             device=mps.device) as svc:
        _instrument(svc, registry)
        removed = []

        def hook(job, b, worker):
            if b == 2 and not removed:
                removed.append(worker)
                svc.remove_worker(worker)
        svc.batch_hook = hook
        h = svc.submit(mps, cfg, n_samples=n * k, key=key, macro_batches=k)
        blocks = dict(h.stream(timeout=600))
        requeues = h.progress["requeues"]
    check(bool(removed) and requeues >= 1
          and all(np.array_equal(blocks[b], refs[b]) for b in range(k)),
          f"service (b): after removing {removed} the job differs "
          f"(requeues {requeues})")
    # a clamped 2-batch job: contract_measure × M a batch, each batch's
    # log_prob the clamped session walk's on its key (phase clamp's path)
    ccfg = api.SamplerConfig(kernels="cuda", clamp=CLAMP_SCALAR)
    with api.SamplingService(workers=SERVICE_LANES, straggler_k=None,
                             device=mps.device) as svc:
        ops.reset_launches()
        h = svc.submit(mps, ccfg, n_samples=2 * n, key=key, macro_batches=2)
        cblocks = dict(h.stream(timeout=600))
        torch.cuda.synchronize()
        claunches = {x: v for x, v in ops.launch_counts().items() if v}
        cstats = h.stats
    check(claunches == {"contract_measure": 2 * sites},
          f"service (b) clamped: launches {claunches}")
    for b in range(2):
        want, lp, _, _ = _clamped_session(mps, n, batch_key(key, b, 2),
                                          CLAMP_SCALAR)
        check(np.array_equal(cblocks[b], want)
              and np.array_equal(cstats[b]["log_prob"], lp),
              f"service (b) clamped: batch {b} differs from the clamped "
              f"session walk (samples or log_prob)")
    out["b"] = {"lanes": lanes, "removed_lane": removed[0],
                "requeues": requeues,
                "clamped_launches": claunches,
                "speedup": lanes["1"]["wall_s"] / lanes[str(
                    SERVICE_LANES)]["wall_s"]}
    print(f"service (b): {k} batches of N={n} == sample(N, fold_in(key, b)) "
          f"on 1 and {SERVICE_LANES} thread lanes, after a lane removed "
          f"mid-job ({removed[0]}, {requeues} requeue), and the clamped "
          f"2-batch job (contract_measure × {sites} a batch, log_prob == "
          f"the clamped session walk's); {json.dumps(out['b'])}; "
          f"{nvidia_smi()}", flush=True)

    # (e) the registry over (b) and (c)
    text = registry.render()
    keep = ("fastmps_jobs_submitted_total", "fastmps_batches_total",
            "fastmps_queue_events_total", "fastmps_transport_events_total",
            "fastmps_jobs_finished_total", "fastmps_transport_lane_faults")
    lines = [ln for ln in text.splitlines()
             if ln.startswith(keep)]
    snap = registry.snapshot()
    requeued = snap["fastmps_queue_events_total"].get(
        ("", (("event", "requeue"),)), 0)
    spawns = snap["fastmps_transport_events_total"].get(
        ("", (("event", "spawn"),)), 0)
    check(snap["fastmps_jobs_submitted_total"][("", ())] >= 4
          and snap["fastmps_batches_total"][("", ())] >= 3 * k
          and requeued >= 2 and spawns >= SERVICE_WORKERS + 1,
          f"service (e): the counters missed events: {lines}")
    out["e"] = {"jobs": snap["fastmps_jobs_submitted_total"][("", ())],
                "batches": snap["fastmps_batches_total"][("", ())],
                "requeues": requeued, "worker_spawns": spawns}
    print("service (e): metrics registry over (b) and (c):\n"
          + "\n".join(lines), flush=True)
    import threading
    lanes = [t.name for t in threading.enumerate()
             if t.name.startswith("sampling-service")]
    check(not lanes, f"service: lane threads left running: {lanes}")
    out["threads_after"] = [t.name for t in threading.enumerate()]
    print(f"service: threads alive after the phase: "
          f"{out['threads_after']}", flush=True)
    _phase("service", t0)
    return out


# ---------------------------------------------------------------------------
# clamp: conditional sampling, kernel 3 on every linear clamped site
# ---------------------------------------------------------------------------

def _clamp_lockstep(label, mps, n, key, mask, vals) -> dict:
    """The clamped walk with the kernels, site by site, each site also run
    by the plain cells from the kernel walk's own env with the same
    uniforms: samples equal (a differing draw is printed with its margin
    to the CDF boundary, and fails), env and dlog within TOL (``compare``),
    dlog_prob within TOL.  Returns the kernel walk's samples (M, N), env,
    log_scale and log_prob, and the largest differences."""
    from repro_torch.core import clamped as CL
    from repro_torch.core import prng
    from repro_torch.core import sampler as S
    from repro_torch.core.parallel import segment_env_init
    from repro_torch.kernels import site_impls as SI
    from repro_torch.kernels import site_step as K

    cfg = {k: S.SamplerConfig(semantics=mps.semantics, kernels=k)
           for k in ("cuda", "torch")}
    env = segment_env_init(n, mps.chi, mps.gammas.dtype, mps.device)
    rdt = torch.float64
    ls = torch.zeros(n, dtype=rdt, device=env.device)
    lp = torch.zeros(n, dtype=rdt, device=env.device)
    vals_t = torch.as_tensor(vals, dtype=torch.int64, device=env.device)
    samples, env_err, lp_err = [], 0.0, 0.0
    for i in range(mps.n_sites):
        g, lam = mps.gammas[i], mps.lambdas[i]
        u = prng.uniform(prng.fold_in(key, i), (n, 1),
                         dtype=SI.site_probs_dtype(env, g, lam,
                                                   mps.semantics, None),
                         device=env.device)
        k, p = (CL._clamped_site_update(env, g, lam, u, bool(mask[i]),
                                        vals_t[i], cfg[c])
                for c in ("cuda", "torch"))
        torch.cuda.synchronize()
        bad = (k[1] != p[1]).nonzero().flatten()
        if bad.numel():
            probs = CL._contract_measure(env, g, lam, cfg["torch"])[1]
            margin = K.draw_margin(probs[bad], u[bad, 0])
            for r, m in zip(bad[:16].tolist(), margin[:16].tolist()):
                print(f"{label}: site {i} row {r} draws differ: margin "
                      f"|u − cdf| {m:.3e}", flush=True)
        env_err = max(env_err, compare(f"{label} site {i}", k[:3], p[:3]))
        d_lp = (k[3] - p[3]).abs().max().item()
        check(torch.allclose(k[3], p[3], **TOL[rdt]),
              f"{label} site {i}: dlog_prob differs (max abs {d_lp:.3e})")
        lp_err = max(lp_err, d_lp)
        env, ls, lp = k[0], ls + k[2], lp + k[3]
        samples.append(k[1])
    print(f"{label}: kernel walk == plain walk in lockstep ({mps.n_sites} "
          f"sites × {n}): env/dlog max abs diff {env_err:.3e}, dlog_prob "
          f"{lp_err:.3e}", flush=True)
    return {"samples": torch.stack(samples), "env": env, "log_scale": ls,
            "log_prob": lp, "env_err": env_err, "log_prob_err": lp_err}


def _clamped_session(mps, n, key, clamp, mesh=None, scheme="seq",
                     measure_first=False):
    """One clamped session walk with the kernels, its launch counts set to
    0 just before and read just after: (samples, log_prob, launches,
    wall seconds)."""
    from repro_torch import api
    from repro_torch.kernels import ops

    cfg = api.SamplerConfig(kernels="cuda", scheme=scheme,
                            measure_first=measure_first, clamp=clamp)
    ops.reset_launches()
    tw = time.perf_counter()
    with api.SamplingSession(mps, cfg, device=mps.device,
                             mesh=mesh) as session:
        samples = session.sample(n, key)
        lp = session.stats.get("log_prob")
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    return samples, lp, {k: v for k, v in ops.launch_counts().items()
                         if v}, wall


def _untouched(label, clamped, free, clamp) -> int:
    """A clamp changes no draw it does not force: every site before the
    first clamped one equals the unclamped walk's, and so does every row
    whose unclamped walk drew the clamped outcomes already.  Returns that
    row count."""
    first = min(clamp)
    check(np.array_equal(clamped[:, :first], free[:, :first]),
          f"{label}: a site before the clamp differs from the free walk")
    hit = np.ones(free.shape[0], dtype=bool)
    for site, v in clamp.items():
        hit &= free[:, site] == np.asarray(v)
    check(np.array_equal(clamped[hit], free[hit]),
          f"{label}: rows whose free walk drew the clamp differ")
    return int(hit.sum())


def phase_clamp(mesh, mps) -> dict:
    """Conditional sampling on phase 4's chain (jiuzhang2 width, fp64,
    M = 8, N = 1024): (a) a scalar clamp on three sites and (b) a
    per-sample clamp on one, through the session with the kernels (M
    launches of ``contract_measure``, none of the fused step) and in
    lockstep with the plain cells; (c) an empty clamp is the unclamped
    walk bit for bit; (d) dp, tp_single (± measure_first) and tp_double on
    the 1×1 mesh are one dp walk: equal bit for bit to the seq walk on the
    shard key ``split(key, 1)[0]``; (f) the clamped and unclamped walks'
    wall times."""
    from repro_torch.core import prng

    t0 = time.perf_counter()
    n, key, sites = LINEAR_N, prng.key(17), mps.n_sites
    out = {}
    # the unclamped walk: the reference the clamp must leave alone, timed
    free, _, free_launches, free_s = _clamped_session(mps, n, key, None)
    free, _, free_launches, free_s = _clamped_session(mps, n, key, None)
    check(free_launches == {"site_step_linear": sites},
          f"clamp: the unclamped walk launched {free_launches}")
    per_sample = {CLAMP_PER_SAMPLE_SITE: [(7 * i) % D for i in range(n)]}
    for part, clamp in (("a", CLAMP_SCALAR), ("b", per_sample)):
        label = f"clamp ({part})"
        samples, lp, launches, wall = _clamped_session(mps, n, key, clamp)
        if part == "a":       # timed warm, as the unclamped walk was
            samples, lp, launches, wall = _clamped_session(mps, n, key,
                                                           clamp)
        check(launches == {"contract_measure": sites},
              f"{label}: launches {launches} on the walk, expected "
              f"contract_measure × {sites}")
        for site, v in clamp.items():
            check(bool((samples[:, site] == np.asarray(v)).all()),
                  f"{label}: site {site} is not clamped")
        check(np.isfinite(lp).all() and (lp < 0).all(),
              f"{label}: log_prob not finite and negative")
        mask, vals = _clamp_arrays(clamp, sites, n)
        ls = _clamp_lockstep(label, mps, n, key, mask, vals)
        check(np.array_equal(ls["samples"].T.cpu().numpy(), samples),
              f"{label}: the session and the lockstep walk differ")
        check(np.array_equal(ls["log_prob"].cpu().numpy(), lp),
              f"{label}: the session's and the lockstep walk's log_prob "
              f"differ")
        hit = _untouched(label, samples, free, clamp)
        out[part] = {"launches": launches, "wall_s": wall,
                     "env_err": ls["env_err"],
                     "log_prob_err": ls["log_prob_err"],
                     "log_prob_mean": float(lp.mean()),
                     "p_clamp": float(np.exp(lp).mean()),
                     "rows_untouched": hit}
        print(f"{label}: session walk N={n} M={sites} in {wall:.3f} s; "
              f"{json.dumps(out[part])}", flush=True)

    empty, lp, launches, _ = _clamped_session(mps, n, key, {})
    check(np.array_equal(empty, free) and lp is None
          and launches == {"site_step_linear": sites},
          f"clamp (c): the empty clamp is not the unclamped walk "
          f"(launches {launches})")
    print(f"clamp (c): clamp={{}} == the unclamped walk bit for bit "
          f"({n * sites} draws, {launches})", flush=True)

    shard_key = prng.split(key, 1)[0]
    seq, seq_lp, _, _ = _clamped_session(mps, n, shard_key, CLAMP_SCALAR)
    out["d"] = {}
    for scheme, mf in CLAMP_SCHEMES:
        label = scheme + ("+measure_first" if mf else "")
        samples, lp, launches, wall = _clamped_session(
            mps, n, key, CLAMP_SCALAR, mesh, scheme, mf)
        check(launches == {"contract_measure": sites},
              f"clamp (d) {label}: launches {launches}")
        check(np.array_equal(samples, seq) and np.array_equal(lp, seq_lp),
              f"clamp (d) {label}: differs from the seq walk on the shard "
              f"key")
        out["d"][label] = {"launches": launches, "wall_s": wall}
    print(f"clamp (d): {', '.join(out['d'])} == the seq clamped walk on "
          f"split(key, 1)[0], bit for bit (samples and log_prob); "
          f"{json.dumps(out['d'])}", flush=True)

    out["unclamped_wall_s"] = free_s
    out["per_site_ms"] = {"clamped": out["a"]["wall_s"] / sites * 1e3,
                          "unclamped": free_s / sites * 1e3}
    out["square"] = _clamp_kernel_numbers(mps, n)
    out["card"] = nvidia_smi()
    print(f"clamp (f): N={n} M={sites} walk {out['a']['wall_s']:.3f} s "
          f"clamped ({out['per_site_ms']['clamped']:.3f} ms a site, "
          f"contract_measure + draw + gather + rescale) vs "
          f"{free_s:.3f} s unclamped ({out['per_site_ms']['unclamped']:.3f} "
          f"ms a site, site_step_linear); {out['card']}", flush=True)
    _phase("clamp", t0)
    return out


def _clamp_kernel_numbers(mps, n) -> dict:
    """Kernel 3 at the clamped walk's shape, the full square χ → χ, on the
    walk's boundary env pushed through site 0 (a rescaled env of one
    sample path a row), against its plain version and ``torch.matmul``."""
    from repro_torch.core import prng
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import site_step as K

    g0, lam0 = mps.gammas[0], mps.lambdas[0]
    env = torch.zeros((n, CHI), dtype=torch.float64, device=g0.device)
    env[:, 0] = 1.0
    u = prng.uniform(prng.key(29), (n,), dtype=torch.float64,
                     device=g0.device)
    env = K.site_step_linear_plain(env, g0, lam0, u)[0]
    gamma, lam = mps.gammas[1], mps.lambdas[1]
    g2 = gamma.reshape(CHI, CHI * D)
    moved = (n * CHI + CHI * CHI * D + CHI + n * CHI * D + n * D) * 8
    flops = 2 * n * CHI * CHI * D + 2 * n * CHI * D
    nums = _kernel_numbers(
        f"contract_measure {CHI}→{CHI} (clamped walk)",
        lambda: CM.contract_measure(env, gamma, lam),
        lambda: CM.contract_measure_plain(env, gamma, lam),
        lambda: torch.matmul(env, g2), moved, flops)
    nums["tflops"] = flops / nums["ms"] / 1e9
    print(f"contract_measure {CHI}→{CHI}: {nums['tflops']:.2f} TFLOP/s "
          f"(library {flops / nums['library_ms'] / 1e9:.2f}), "
          f"{nums['bound_ms'] / nums['ms']:.1%} of the bound; "
          f"{nvidia_smi()}", flush=True)
    del env, g2
    torch.cuda.empty_cache()
    return dict(nums, shape={"n": n, "L": CHI, "R": CHI, "d": D})


def phase_clamp_born(mps) -> dict:
    """(e) A Born clamped walk on the Born phase's chain (complex128, M = 4,
    N = 512; its contraction is the plain complex product, as the Born TP
    steps'): in lockstep with the plain cells, the clamp enforced, and the
    draws it does not force equal to the unclamped kernel walk's."""
    from repro_torch.core import prng

    t0 = time.perf_counter()
    n, key, sites = BORN_N, prng.key(19), mps.n_sites
    free, _, free_launches, free_s = _clamped_session(mps, n, key, None)
    samples, lp, launches, wall = _clamped_session(mps, n, key, CLAMP_BORN)
    check(free_launches == {"site_step_born": sites} and not launches,
          f"clamp (e): launches {free_launches}, {launches}")
    for site, v in CLAMP_BORN.items():
        check(bool((samples[:, site] == v).all()),
              f"clamp (e): site {site} is not clamped")
    check(np.isfinite(lp).all() and (lp < 0).all(),
          "clamp (e): log_prob not finite and negative")
    mask, vals = _clamp_arrays(CLAMP_BORN, sites, n)
    ls = _clamp_lockstep("clamp (e) born", mps, n, key, mask, vals)
    check(np.array_equal(ls["samples"].T.cpu().numpy(), samples)
          and np.array_equal(ls["log_prob"].cpu().numpy(), lp),
          "clamp (e): the session and the lockstep walk differ")
    hit = _untouched("clamp (e)", samples, free, CLAMP_BORN)
    out = {"wall_s": wall, "unclamped_wall_s": free_s,
           "env_err": ls["env_err"], "log_prob_err": ls["log_prob_err"],
           "p_clamp": float(np.exp(lp).mean()), "rows_untouched": hit,
           "card": nvidia_smi()}
    print(f"clamp (e) born: N={n} M={sites} clamped walk {wall:.3f} s vs "
          f"unclamped {free_s:.3f} s; {json.dumps(out)}", flush=True)
    _phase("clamp born", t0)
    return out


def _device_times(name, out, kernel, plain, library, reps) -> None:
    """Replace ``out``'s CUDA-event times of kernel, plain and library by
    their device times (``device_time_ms``; the kernel one launch a call),
    kept beside them as ``events_*``."""
    for k in ("ms", "plain_ms", "library_ms"):
        out["events_" + k] = out[k]
    out.update(ms=device_time_ms(kernel, reps, 1),
               plain_ms=device_time_ms(plain, reps),
               library_ms=device_time_ms(library, reps))
    print(f"{name}: CUDA-event times (host launch included) "
          f"ms={out['events_ms']:.4f} plain_ms={out['events_plain_ms']:.4f} "
          f"library_ms={out['events_library_ms']:.4f}; device times follow",
          flush=True)


def _kernel_numbers(name, kernel, plain, library, moved, flops, reps=5,
                    device=False):
    """Kernel vs plain on the same inputs; times (CUDA events, or with
    ``device`` ``_device_times``) and bound."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        check(torch.allclose(g / scale, w / scale, **TOL[w.dtype]),
              f"{name}: kernel and plain differ (max abs "
              f"{(g - w).abs().max().item():.3e})")
        err = max(err, (g - w).abs().max().item())
    del got, want
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    out = {"max_abs_err": err, "ms": time_ms(kernel, reps),
           "plain_ms": time_ms(plain, reps),
           "library_ms": time_ms(library, reps),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if device:
        _device_times(name, out, kernel, plain, library, reps)
    print(f"{name}: ms={out['ms']:.3f} plain_ms={out['plain_ms']:.3f} "
          f"library_ms={out['library_ms']:.3f} bound_ms={out['bound_ms']:.3f}"
          f" ({out['bound_by']}: {moved / 1e9:.3f} GB, {flops / 1e12:.4f} "
          f"TFLOP) max_abs_err={err:.3e}", flush=True)
    return out


def phase_tp_kernels(device, mps, env, walks) -> list:
    """The three TP kernels at the bond-shard shapes of p₂ = 4 (N = 1024),
    on the chain's site 0 and the linear walk's final env."""
    from repro_torch.kernels import collapse_select as CS
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    n, shard = env.shape[0], CHI // TP_SHARDS
    gamma, lam = mps.gammas[0], mps.lambdas[0]
    env_s = env[:, :shard].contiguous()             # (N, χ/p₂)
    g_left = gamma[:shard]                           # (χ/p₂, χ, d)
    g_right = gamma[:, :shard].contiguous()          # (χ, χ/p₂, d)
    lam_s = lam[:shard].contiguous()
    w8 = 8                                           # bytes per fp64 word

    cm = []
    for e, g, l_ in ((env_s, g_left, lam), (env, g_right, lam_s)):
        (L, R, d) = g.shape
        g2 = g.reshape(L, R * d)
        moved = (n * L + L * R * d + R + n * R * d + n * d) * w8
        flops = 2 * n * L * R * d + 2 * n * R * d
        nums = _kernel_numbers(
            f"contract_measure {L}→{R}", lambda: CM.contract_measure(e, g, l_),
            lambda: CM.contract_measure_plain(e, g, l_),
            lambda: torch.matmul(e, g2), moved, flops)
        if not cm:
            # the card's clock and power under the kernel and under cuBLAS
            nums["device_state"] = device_state(
                lambda: CM.contract_measure(e, g, l_))
            nums["library_device_state"] = device_state(
                lambda: torch.matmul(e, g2))
        print(f"contract_measure {L}→{R}: {flops / nums['ms'] / 1e9:.2f} "
              f"TFLOP/s (library {flops / nums['library_ms'] / 1e9:.2f}), "
              f"{nums['bound_ms'] / nums['ms']:.1%} of the bound; card while "
              f"kernel and library run "
              f"{json.dumps(nums.get('device_state'))}, "
              f"{json.dumps(nums.get('library_device_state'))}", flush=True)
        cm.append(dict(nums, shape={"n": n, "L": L, "R": R, "d": d}))
    tp_single = walks["tp_single"]["launches"]["contract_measure"]
    entries = [dict(cm[0], name="contract_measure", route="cuda",
                    source="src/repro_torch/kernels/csrc/site_step.cu",
                    replaces="src/repro/kernels/contract_measure.py:92",
                    launches=tp_single,
                    launches_tp_double=walks["tp_double"]["launches"][
                        "contract_measure"],
                    other_shapes=cm[1:])]

    w = CS.measure_weights(g_left.to(torch.float32), lam.to(torch.float32)
                           ).to(torch.float64)      # as the walk builds W
    moved = (n * shard + shard * D + n * D) * w8
    nums = _kernel_numbers(
        f"measure_probs {shard}", lambda: K.measure_probs(env_s, w),
        lambda: K.measure_first_plain(env_s, w), lambda: env_s @ w,
        moved, 2 * n * shard * D, reps=20, device=True)
    print(f"measure_probs {shard}: {moved / nums['ms'] / 1e6:.1f} GB/s "
          f"(library {moved / nums['library_ms'] / 1e6:.1f}), "
          f"{nums['bound_ms'] / nums['ms']:.1%} of the bound", flush=True)
    mf = walks["tp_single+measure_first"]["launches"]
    entries.append(dict(nums, name="measure_probs", route="cuda",
                        source="src/repro_torch/kernels/csrc/site_step.cu",
                        replaces="src/repro/kernels/site_step.py:379",
                        launches=mf["measure_probs"],
                        shape={"n": n, "L": shard, "d": D}))

    gen = torch.Generator(device=device).manual_seed(5)
    samples = torch.randint(0, D, (n,), generator=gen, device=device)
    present = int(torch.unique(samples).numel())
    g2 = g_left.reshape(shard, CHI * D)
    nums = _kernel_numbers(
        f"collapse_select {shard}→{CHI}",
        lambda: CS.collapse_select(env_s, g_left, samples),
        lambda: CS.collapse_select_plain(env_s, g_left, samples),
        lambda: torch.matmul(env_s, g2),
        (n * shard + shard * CHI * present + n + n * CHI) * w8,
        2 * n * shard * CHI)
    nums["tflops"] = 2 * n * shard * CHI / nums["ms"] / 1e9
    print(f"collapse_select {shard}→{CHI}: {nums['tflops']:.2f} TFLOP/s, "
          f"{nums['bound_ms'] / nums['ms']:.1%} of the bound", flush=True)
    entries.append(dict(nums, name="collapse_select", route="cuda",
                        source="src/repro_torch/kernels/csrc/site_step.cu",
                        replaces="src/repro/kernels/collapse_select.py:83",
                        launches=mf["collapse_select"],
                        shape={"n": n, "L": shard, "R": CHI, "d": D,
                               "outcomes_present": present}))
    del env_s, g_right, w, g2
    torch.cuda.empty_cache()
    _phase("tp kernels", t0)
    return entries


# ---------------------------------------------------------------------------
# bf16 inputs: the mxu_bf16 and store_bf16 tiers
# ---------------------------------------------------------------------------

def _bf16_site_bounds(e_k, e_p, gamma, lam, w):
    """Plain probs of one site under bf16 inputs, from the plain walk's env
    ``e_p`` (env·W when ``w`` is given, the measure-first cell; else
    temp·Λ), and bounds on how far the kernel walk's site, from its env
    ``e_k``, may lie from them: (probs (N, d), probs bound, temp bound
    (N, R, d)).  The bounds add the sum-order bounds of the kernels
    (``site_step_bf16_bounds``, ``bf16_gemm_bound``, on the larger of the
    two envs) and the part of the inputs that differ after rounding, D =
    |bf16(e_k) − bf16(e_p)|: D·|Γ| for temp, D·(|Γ|·Λ) or D·|W| for probs
    (D is 0 where both walks start from the same env)."""
    from repro_torch.core import precision
    from repro_torch.kernels import site_step as K

    bf, f64 = torch.bfloat16, torch.float64
    chi_l, chi_r, d = gamma.shape
    big = torch.maximum(e_k.abs(), e_p.abs())
    diff = (precision.rounded(e_k, bf, f64)
            - precision.rounded(e_p, bf, f64)).abs()
    g_abs = precision.rounded(gamma.reshape(chi_l, chi_r * d), bf, f64).abs()
    temp_b = (K.bf16_gemm_bound(big, gamma.reshape(chi_l, chi_r * d))
              + diff @ g_abs).reshape(-1, chi_r, d)
    if w is not None:
        probs = K.measure_first_plain(e_p, w, bf).double()
        pb = K.bf16_gemm_bound(big, w) + diff @ precision.rounded(
            w, bf, f64).abs()
    else:
        probs = K.linear_probs_plain(K.contract_plain(e_p, gamma, bf),
                                     lam).double()
        pb = K.site_step_bf16_bounds(big, gamma, lam)[0] + diff @ (
            g_abs.reshape(chi_l, chi_r, d) * lam.double().abs()[:, None]
        ).sum(dim=1)
    return probs, pb, temp_b


def _bf16_lockstep(label, mps, n, ukey, run, seg, weights=None) -> dict:
    """The kernel walk, ``seg`` sites at a time (``run(kernels, env,
    log_scale, i0, i1)`` → samples (i1 − i0, N), env, log_scale), each
    segment also run by the plain cells from the kernel walk's own env and
    log_scale, and held to them site by site.  A draw may differ only where
    the uniform lies within the CDF's bound of a boundary (``draw_margin``
    ≤ 2·Σ_s probs bound_s / Σ_s probs_s); each such draw is printed with
    its margin and its row leaves the later comparisons.  The segment's
    env' and its dlog (the log_scale increment) agree on the other rows
    within 2·B/max plus their own fp32 roundings, B the largest temp bound
    of the row's drawn column.  Inside a two-site segment the walks' mid-pair envs may
    differ by bf16 rounding flips, which the bounds carry (D in
    :func:`_bf16_site_bounds`); the kernel walk's is replayed by
    ``contract_measure``, as tp_double's odd half-site computes it on a
    1 × 1 mesh.  Returns the kernel walk's samples, its final env, the
    differing draws and the largest differences and shares of the
    bounds."""
    from repro_torch.core import precision, prng
    from repro_torch.core.parallel import segment_env_init
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import site_step as K

    bf = torch.bfloat16
    sites = mps.n_sites
    env_k = segment_env_init(n, mps.chi, mps.gammas.dtype, mps.device)
    ls_k = torch.zeros(n, dtype=env_k.dtype, device=env_k.device)
    live = torch.ones(n, dtype=torch.bool, device=env_k.device)
    flips, samples = [], []
    worst = {"env_err": 0.0, "log_scale_err": 0.0, "env_share": 0.0,
             "log_scale_share": 0.0}
    for i0 in range(0, sites, seg):
        i1 = min(sites, i0 + seg)
        env_in, ls_in = env_k, ls_k
        s_k, env_k, ls_k = run("cuda", env_in, ls_in, i0, i1)
        s_p, env_p, ls_p = run("torch", env_in, ls_in, i0, i1)
        samples.append(s_k)
        e_k = e_p = env_in
        dlog_b = torch.zeros(n, dtype=torch.float64, device=env_k.device)
        for j in range(i1 - i0):
            i = i0 + j
            gamma, lam = mps.gammas[i], mps.lambdas[i]
            probs, pb, tb = _bf16_site_bounds(
                e_k, e_p, gamma, lam, None if weights is None else weights[i])
            bad = (live & (s_k[j] != s_p[j])).nonzero().flatten()
            if bad.numel():
                u = prng.uniform(prng.fold_in(ukey, i), (n,),
                                 dtype=e_p.dtype, device=e_p.device)[bad]
                margin = K.draw_margin(probs[bad], u)
                bound = 2 * pb[bad].sum(dim=1) / probs[bad].sum(dim=1)
                for r, m, b in zip(bad.tolist(), margin.tolist(),
                                   bound.tolist()):
                    print(f"{label}: site {i} row {r} draws differ: margin "
                          f"|u − cdf| {m:.3e}, bound {b:.3e}", flush=True)
                    check(m <= b, f"{label}: site {i} row {r} draws differ "
                          f"{m:.3e} from a CDF boundary, beyond the "
                          f"rounding bound {b:.3e}")
                    flips.append({"site": i, "row": r, "margin": m,
                                  "bound": b})
                live[bad] = False
            s = s_p[j][:, None, None]
            t_p = K.contract_plain(e_p, gamma, bf)
            peak = torch.take_along_dim(t_p, s, dim=2)[:, :, 0].double().abs(
                ).amax(dim=1)
            rel = torch.take_along_dim(tb, s, dim=2)[:, :, 0].amax(
                dim=1) / peak
            # the max, then both walks' fp32 log10 (within 2 ulp) and
            # log_scale additions
            dlog_b += 2 * rel / np.log(10) + 2.0 ** -20 * (
                peak.log10().abs() + ls_in.double().abs() + 1)
            if j + 1 < i1 - i0:        # both walks' envs after site i
                t_k = CM.contract_measure(e_k, gamma, lam, bf)[0]
                e_k = precision.rescale(torch.take_along_dim(
                    t_k, s_k[j][:, None, None], dim=2)[:, :, 0])[0]
                e_p = precision.rescale(torch.take_along_dim(
                    t_p, s, dim=2)[:, :, 0])[0]
        env_b = 2 * rel[:, None] + 2.0 ** -23
        d_env = (env_k - env_p).abs().double()
        d_ls = ((ls_k - ls_in) - (ls_p - ls_in)).abs().double()
        env_share = (d_env / env_b)[live].max().item()
        ls_share = (d_ls / dlog_b)[live].max().item()
        check(env_share <= 1.0 and ls_share <= 1.0 and
              bool(torch.isfinite(ls_k).all()),
              f"{label}: sites {i0}..{i1 - 1}: env or log_scale beyond the "
              f"rounding bound ({env_share:.3f}, {ls_share:.3f} of it)")
        worst = {"env_err": max(worst["env_err"], d_env[live].max().item()),
                 "log_scale_err": max(worst["log_scale_err"],
                                      d_ls[live].max().item()),
                 "env_share": max(worst["env_share"], env_share),
                 "log_scale_share": max(worst["log_scale_share"], ls_share)}
    print(f"{label}: kernel walk == plain walk on {int(live.sum())} of {n} "
          f"rows ({len(flips)} draws within the bound of a CDF boundary "
          f"differ); per segment env max abs diff {worst['env_err']:.3e} "
          f"({worst['env_share']:.3f} of the bound), log_scale "
          f"{worst['log_scale_err']:.3e} ({worst['log_scale_share']:.3f})",
          flush=True)
    return {"samples": torch.cat(samples), "env": env_k, "flips": flips,
            **worst}


def _bf16_numbers(name, kernel, plain, library, checked, moved, flops,
                  reps=5, device=False):
    """A bf16-input kernel against its plain version on the same inputs:
    ``checked`` is [(kernel output, plain output, elementwise rounding
    bound)]; times of kernel, plain and library (``device``: as
    ``_kernel_numbers``), and the bound (bytes at the HBM rate, operations
    at the bf16 tensor-core peak)."""
    err = excess = 0.0
    for g, w, b in checked:
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}"
              f"{tuple(w.shape)}")
        diff = (g.double() - w.double()).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff / b).nan_to_num(0.0).max().item())
    check(excess <= 1.0, f"{name}: kernel and plain differ beyond the "
          f"rounding bound ({excess:.3f} of it)")
    del checked
    lib_out = library()
    bound_ms, bound_by = _bound(moved, flops, PEAK_BF16_FLOPS)
    out = {"max_abs_err": err, "of_rounding_bound": excess,
           "ms": time_ms(kernel, reps), "plain_ms": time_ms(plain, reps),
           "library_ms": time_ms(library, reps),
           "library_out_dtype": str(lib_out.dtype),
           "bound_ms": bound_ms, "bound_by": bound_by}
    del lib_out
    if device:
        _device_times(name, out, kernel, plain, library, reps)
    out["tflops"] = flops / out["ms"] / 1e9
    out["of_bound"] = bound_ms / out["ms"]
    print(f"{name}: ms={out['ms']:.3f} plain_ms={out['plain_ms']:.3f} "
          f"library_ms={out['library_ms']:.3f} ({out['library_out_dtype']} "
          f"out) bound_ms={bound_ms:.3f} ({bound_by}: {moved / 1e9:.3f} GB, "
          f"{flops / 1e12:.4f} TFLOP) {out['tflops']:.1f} TFLOP/s, "
          f"{out['of_bound']:.1%} of the bound; max_abs_err={err:.3e} "
          f"({excess:.4f} of the rounding bound)", flush=True)
    return out


def phase_bf16(device, mesh, mps64) -> list:
    """The bf16 tiers at the linear phase's width, on its chain cast to fp32
    (``mxu_bf16``) and to bf16 with Λ in fp32 (``store_bf16``): the session
    walks with bf16 GEMM inputs through ``site_step_linear``'s bf16 entry,
    each against the plain walk; tp_single (± measure_first) and tp_double
    in mxu_bf16 on the mesh; the four bf16 kernels against their plain
    versions at the walk's and the p₂ = 4 shard shapes, with times.
    Returns the kernels-line rows."""
    from repro_torch import api
    from repro_torch.core import parallel as PP
    from repro_torch.core import prng
    from repro_torch.core import sampler as S
    from repro_torch.core.mps import MPS
    from repro_torch.kernels import collapse_select as CS
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import ops
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    bf = torch.bfloat16
    n, sites = LINEAR_N, mps64.n_sites
    chains = {"mxu_bf16": mps64.to(dtype=torch.float32)}
    chains["store_bf16"] = chains["mxu_bf16"].to(dtype=bf)
    for tier, m in chains.items():
        print(f"bf16 {tier}: Γ {m.gammas.dtype} "
              f"{m.gammas.numel() * m.gammas.element_size() / 1e9:.3f} GB, "
              f"Λ {m.lambdas.dtype}", flush=True)
    key, walks, finals = prng.key(7), {}, {}
    for tier, m in chains.items():
        cfg = api.SamplerConfig(kernels="cuda", compute_dtype=bf)
        # the main path: counts set to 0 just before, read just after
        ops.reset_launches()
        tw = time.perf_counter()
        with api.SamplingSession(m, cfg, device=device) as session:
            samples = session.sample(n, key)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - tw
        launches = ops.launch_counts()
        print(f"bf16 {tier}: session walk N={n} M={sites} in {walk_s:.3f} s; "
              f"launches {launches}", flush=True)
        check(launches["site_step_linear_bf16"] == sites,
              f"bf16 {tier}: site_step_linear's bf16 entry launched "
              f"{launches['site_step_linear_bf16']} times, expected {sites}")
        check(samples.shape == (n, sites) and samples.min() >= 0
              and samples.max() < D, f"bf16 {tier}: bad samples")

        def seq(kernels, env, ls, i0, i1, m=m):
            c = S.SamplerConfig(kernels=kernels, compute_dtype=bf)
            st, (smp, _) = S.site_step(S.SamplerState(env, key, ls),
                                       (m.gammas[i0], m.lambdas[i0], i0), c)
            return smp[None], st.env, st.log_scale

        res = _bf16_lockstep(f"bf16 {tier}", m, n, key, seq, 1)
        check(np.array_equal(res["samples"].T.cpu().numpy(), samples),
              f"bf16 {tier}: session and kernel walk differ")
        walks[tier] = {"launches": launches["site_step_linear_bf16"],
                       "walk_s": walk_s,
                       **{k: v for k, v in res.items()
                          if k not in ("samples", "env")}}
        finals[tier] = res["env"]

    # tensor-parallel schedules in mxu_bf16 on the 1 × 1 mesh
    m = chains["mxu_bf16"]
    ukey = prng.split(key, 1)[0]
    tp_launches = {}
    for (scheme, mf), names in TP_WALKS.items():
        if scheme == "dp":
            continue
        label = f"bf16 mxu_bf16 {scheme}" + ("+measure_first" if mf else "")
        cfg = api.SamplerConfig(kernels="cuda", scheme=scheme,
                                measure_first=mf, compute_dtype=bf)
        ops.reset_launches()
        with api.SamplingSession(m, cfg, mesh=mesh) as session:
            samples = session.sample(n, key)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        for k in names:
            check(launches[k + "_bf16"] == sites, f"{label}: {k}'s bf16 "
                  f"entry launched {launches[k + '_bf16']} times, expected "
                  f"{sites}")
        tp_launches[label] = {k: launches[k + "_bf16"] for k in names}
        pc = PP.ParallelConfig(scheme=scheme, measure_first=mf)

        def tp(kernels, env, ls, i0, i1, pc=pc):
            c = S.SamplerConfig(kernels=kernels, compute_dtype=bf)
            seg = PP.rank_chain(mesh, MPS(m.gammas[i0:i1], m.lambdas[i0:i1]),
                                pc)
            smp, env, ls = PP.sample_segment(mesh, seg, env, key, i0, pc, c,
                                             log_scale=ls)
            return smp, env, ls

        weights = ([CS.measure_weights(m.gammas[i].float(),
                                       m.lambdas[i].float())
                    for i in range(sites)] if mf else None)
        res = _bf16_lockstep(label, m, n, ukey, tp,
                             2 if scheme == "tp_double" else 1, weights)
        check(np.array_equal(res["samples"].T.cpu().numpy(), samples),
              f"{label}: session and segment walk differ")
        print(f"{label}: launches {tp_launches[label]}", flush=True)

    # the four kernels: the walk's shapes, then the p₂ = 4 shard shapes
    rows = {"site_step_linear_bf16": [], "contract_measure_bf16": [],
            "measure_probs_bf16": [], "collapse_select_bf16": []}
    shard = CHI // TP_SHARDS
    for tier, m in chains.items():
        env, gamma, lam = finals[tier], m.gammas[0], m.lambdas[0]
        u = prng.uniform(prng.fold_in(key, 0), (n,), dtype=lam.dtype,
                         device=device)
        wg = gamma.element_size()
        pb, tb = K.site_step_bf16_bounds(env, gamma, lam)
        e_k, s_k, d_k = K.site_step_linear(env, gamma, lam, u,
                                           compute_dtype=bf)
        e_p, s_p, d_p = K.site_step_linear_plain(env, gamma, lam, u,
                                                 compute_dtype=bf)
        probs = K.linear_probs_plain(K.contract_plain(env, gamma, bf),
                                     lam).double()
        flip = (s_k != s_p).nonzero().flatten()
        cdf_bound = 2 * pb.sum(dim=1) / probs.sum(dim=1)
        check(bool((K.draw_margin(probs, u)[flip] <= cdf_bound[flip]).all()),
              f"bf16 {tier} site: draws differ beyond the rounding bound")
        keep = s_k == s_p
        # env' = temp[:, :, s]/max in both: 2·B/max apart, B the row's
        # temp bound; dlog = log10(max) likewise; plus their own roundings
        mx = (torch.take_along_dim(K.contract_plain(env, gamma, bf),
                                   s_p[:, None, None], dim=2)[:, :, 0]
              .double().abs().amax(dim=1))
        rel = torch.take_along_dim(tb, s_p[:, None, None], dim=2)[
            :, :, 0].amax(dim=1) / mx
        checked = [(e_k[keep], e_p[keep], (2 * rel + 2.0 ** -23)[keep, None]),
                   (d_k[keep], d_p[keep],
                    (2 * rel + 2.0 ** -20 * (mx.log10().abs() + 1))[keep])]
        del tb, pb, mx, probs
        g2 = gamma.reshape(CHI, CHI * D)
        eb, gb2 = env.to(bf), g2.to(bf)
        row = _bf16_numbers(
            f"bf16 {tier} site_step_linear N={n} χ={CHI}",
            lambda: K.site_step_linear(env, gamma, lam, u, compute_dtype=bf),
            lambda: K.site_step_linear_plain(env, gamma, lam, u,
                                             compute_dtype=bf),
            lambda: torch.matmul(eb, gb2), checked,
            4 * (2 * n * CHI + CHI + 3 * n) + wg * CHI * CHI * D,
            2 * CHI * CHI * D + 2 * n * CHI * D + 2 * n * CHI * CHI)
        step = lambda: K.site_step_linear(env, gamma, lam, u,  # noqa: E731
                                          compute_dtype=bf)
        parts = breakdown_of(step, ("weights_planes_kernel",
                                    "bf16_rows_kernel", "wgmma_bf16_kernel"),
                             6)
        rate = _rate(2 * n * CHI * CHI, parts, "wgmma_bf16_kernel")
        state = device_state(step)
        print(f"bf16 {tier}: device ms by kernel in one site_step_linear "
              f"bf16 call (torch.profiler; weights_planes_kernel: W and Γ's "
              f"bf16 planes, bf16_rows_kernel: env in bucket order, "
              f"wgmma_bf16_kernel: the grouped collapse at {rate} TFLOP/s): "
              f"{json.dumps(parts)}; the card under the step: "
              f"{json.dumps(state)}", flush=True)
        rows["site_step_linear_bf16"].append(dict(
            row, tier=tier, draws_differing=int(flip.numel()), parts=parts,
            collapse_tflops=rate, device=state,
            shape={"n": n, "chi": CHI, "d": D, "env": str(env.dtype),
                   "gamma": str(gamma.dtype)}))
        del e_k, e_p, eb, gb2, g2
        torch.cuda.empty_cache()

        env_s = env[:, :shard].contiguous()
        g_left, g_right = gamma[:shard], gamma[:, :shard].contiguous()
        lam_s = lam[:shard].contiguous()
        for e, g, l_ in ((env_s, g_left, lam), (env, g_right, lam_s)):
            L, R, d = g.shape
            g2 = g.reshape(L, R * d)
            tb = K.bf16_gemm_bound(e, g2).reshape(n, R, d)
            eps_p = 2 * R * 2.0 ** -24
            t_p = CM.contract_measure_plain(e, g, l_, bf)[0]
            pbound = torch.einsum("nrs,r->ns", tb + eps_p * t_p.double()
                                  .abs(), l_.double())
            del t_p
            eb, gb2 = e.to(bf), g2.to(bf)
            row = _bf16_numbers(
                f"bf16 {tier} contract_measure {L}→{R}",
                lambda: CM.contract_measure(e, g, l_, bf),
                lambda: CM.contract_measure_plain(e, g, l_, bf),
                lambda: torch.matmul(eb, gb2),
                list(zip(CM.contract_measure(e, g, l_, bf),
                         CM.contract_measure_plain(e, g, l_, bf),
                         (tb, pbound))),
                4 * (n * L + R + n * R * d + n * d) + wg * L * R * d,
                2 * n * L * R * d + 2 * n * R * d)
            call = lambda: CM.contract_measure(e, g, l_, bf)  # noqa: E731
            copied = (g.dtype != bf or R * d % 8 != 0
                      or g.data_ptr() % 16 != 0)      # Γ's bf16 copy
            parts = breakdown_of(call, ("bf16_rows_kernel",
                                        "wgmma_bf16_kernel", "probs_kernel"),
                                 3 + copied)
            rate = _rate(2 * n * L * R * d, parts, "wgmma_bf16_kernel")
            state = device_state(call) if L < R else None
            print(f"bf16 {tier} contract_measure {L}→{R}: device ms by "
                  f"kernel (torch.profiler; bf16_rows_kernel: env's and Γ's "
                  f"bf16 copies, wgmma_bf16_kernel: the GEMM at {rate} "
                  f"TFLOP/s): {json.dumps(parts)}"
                  + (f"; the card under it: {json.dumps(state)}"
                     if state else ""), flush=True)
            rows["contract_measure_bf16"].append(dict(
                row, tier=tier, parts=parts, device=state, gemm_tflops=rate,
                shape={"n": n, "L": L, "R": R, "d": d,
                       "gamma": str(g.dtype)}))
            del tb, pbound, eb, gb2
            torch.cuda.empty_cache()

        gen = torch.Generator(device=device).manual_seed(5)
        smp = torch.randint(0, D, (n,), generator=gen, device=device)
        present = int(torch.unique(smp).numel())
        g2 = g_left.reshape(shard, CHI * D)
        ob = torch.take_along_dim(
            K.bf16_gemm_bound(env_s, g2).reshape(n, CHI, D),
            smp[:, None, None], dim=2)[:, :, 0]
        eb, gb2 = env_s.to(bf), g2.to(bf)
        row = _bf16_numbers(
            f"bf16 {tier} collapse_select {shard}→{CHI}",
            lambda: CS.collapse_select(env_s, g_left, smp, bf),
            lambda: CS.collapse_select_plain(env_s, g_left, smp, bf),
            lambda: torch.matmul(eb, gb2),
            [(CS.collapse_select(env_s, g_left, smp, bf),
              CS.collapse_select_plain(env_s, g_left, smp, bf), ob)],
            4 * (n * shard + n + n * CHI) + wg * shard * CHI * present,
            2 * n * shard * CHI)
        call = lambda: CS.collapse_select(  # noqa: E731
            env_s, g_left, smp, bf)
        parts = breakdown_of(call, ("weights_planes_kernel", "bucket_kernel",
                                    "zero_rows_kernel", "bf16_rows_kernel",
                                    "wgmma_bf16_kernel"), 5)
        rate = _rate(2 * n * shard * CHI, parts, "wgmma_bf16_kernel")
        state = device_state(call)
        scratch_bytes = 2 * (n * K.padded(shard) + D * shard * K.padded(CHI))
        print(f"bf16 {tier} collapse_select {shard}→{CHI}: device ms by "
              f"kernel (torch.profiler; weights_planes_kernel: Γ's bf16 "
              f"planes, bucket_kernel: the rows by outcome, zero_rows_kernel:"
              f" env' of rows of no outcome, bf16_rows_kernel: env in bucket "
              f"order, wgmma_bf16_kernel: the grouped collapse at {rate} "
              f"TFLOP/s): {json.dumps(parts)}; scratch {scratch_bytes} "
              f"bytes; the card under it: {json.dumps(state)}", flush=True)
        rows["collapse_select_bf16"].append(dict(
            row, tier=tier, parts=parts, gemm_tflops=rate, device=state,
            device_ms=sum(t * c for t, c in parts.values()),
            scratch_bytes=scratch_bytes,
            shape={"n": n, "L": shard, "R": CHI, "d": D,
                   "gamma": str(g_left.dtype), "outcomes_present": present}))
        del ob, eb, gb2, g2
        if tier == "mxu_bf16":          # W is fp32 in both tiers
            w = CS.measure_weights(g_left.float(), lam.float())
            eb, wb = env_s.to(bf), w.to(bf)
            moved = 4 * (n * shard + shard * D + n * D)
            row = _bf16_numbers(
                f"bf16 measure_probs {shard}",
                lambda: K.measure_probs(env_s, w, bf),
                lambda: K.measure_first_plain(env_s, w, bf),
                lambda: torch.matmul(eb, wb),
                [(K.measure_probs(env_s, w, bf),
                  K.measure_first_plain(env_s, w, bf),
                  K.bf16_gemm_bound(env_s, w))],
                moved, 2 * n * shard * D, reps=20, device=True)
            print(f"bf16 measure_probs {shard}: "
                  f"{moved / row['ms'] / 1e6:.1f} GB/s, "
                  f"{row['bound_ms'] / row['ms']:.1%} of the bound",
                  flush=True)
            rows["measure_probs_bf16"].append(dict(
                row, tier="both", shape={"n": n, "L": shard, "d": D}))
            del eb, wb, w
        del env_s, g_right, lam_s
        torch.cuda.empty_cache()

    replaces = {"site_step_linear_bf16": "src/repro/kernels/site_step.py:181",
                "contract_measure_bf16":
                    "src/repro/kernels/contract_measure.py:92",
                "measure_probs_bf16": "src/repro/kernels/site_step.py:379",
                "collapse_select_bf16":
                    "src/repro/kernels/collapse_select.py:83"}
    mf = tp_launches["bf16 mxu_bf16 tp_single+measure_first"]
    launches = {"site_step_linear_bf16": walks["mxu_bf16"]["launches"],
                "contract_measure_bf16": tp_launches[
                    "bf16 mxu_bf16 tp_single"]["contract_measure"],
                "measure_probs_bf16": mf["measure_probs"],
                "collapse_select_bf16": mf["collapse_select"]}
    entries = []
    for name, found in rows.items():
        entries.append(dict(
            found[0], name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/site_step.cu",
            replaces=replaces[name], launches=launches[name],
            other_shapes=found[1:]))
    entries[0]["walks"] = walks
    entries[1]["launches_tp_double"] = tp_launches[
        "bf16 mxu_bf16 tp_double"]["contract_measure"]
    del chains, finals
    torch.cuda.empty_cache()
    _phase("bf16", t0)
    return entries


def phase_tp_born(mesh, mps) -> None:
    """A Born tp_double walk on the mesh (its contraction stays plain
    PyTorch by design) against the Born dp walk, which runs the kernel."""
    from repro_torch import api
    from repro_torch.core import prng

    t0 = time.perf_counter()
    n, key = BORN_N, prng.key(13)
    tw = time.perf_counter()
    cfg = api.SamplerConfig(kernels="cuda", scheme="tp_double")
    with api.SamplingSession(mps, cfg, mesh=mesh) as session:
        samples = session.sample(n, key)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - tw
    td = _segment(mesh, mps, n, key, "tp_double", False, "cuda")
    dp = _segment(mesh, mps, n, key, "dp", False, "cuda")
    torch.cuda.synchronize()
    check(np.array_equal(td[0].T.cpu().numpy(), samples),
          "born tp_double: session and segment walk differ")
    env_err, ls_err = _same_walk("born tp_double vs dp", td, dp)
    print(f"born tp_double: session walk N={n} M={mps.n_sites} in "
          f"{walk_s:.3f} s; == the dp walk ({n * mps.n_sites} draws), env "
          f"max abs diff {env_err:.3e}, log_scale max abs diff "
          f"{ls_err:.3e}", flush=True)
    _phase("tp born", t0)


def _bound(moved: float, flops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) for the bytes and the operations, and which."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_displacement(device) -> dict:
    """``ops.displacement_matrices`` on B = 2²⁰ μ's against the plain version,
    at d = 4 and 16 in complex128 and complex64; returns the kernels-line
    entry (d = 4, fp64, with the other shapes beside it).  Each shape's
    planes entry (the TPU kernel's layout) and main path timed by CUDA
    events and by device time; the main path must run one kernel, the
    complex entry, and nothing else (no join of planes, no copies of μ)."""
    from repro_torch.kernels import displacement_expm as DE
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(17)
    r = 1.5 * torch.sqrt(torch.rand(DISP_BATCH, generator=gen, device=device,
                                    dtype=torch.float64))
    phi = 2 * np.pi * torch.rand(DISP_BATCH, generator=gen, device=device,
                                 dtype=torch.float64)
    r[0] = 0.0                                        # μ = 0 → I
    mu64 = torch.polar(r, phi)
    shapes = [(d, cd) for d in DISP_DS
              for cd in (torch.complex128, torch.complex64)]
    mus = {cd: mu64.to(cd) for cd in (torch.complex128, torch.complex64)}
    # the main path: counts set to 0 just before, read just after
    ops.reset_launches()
    outs = [ops.displacement_matrices(mus[cd], d) for d, cd in shapes]
    torch.cuda.synchronize()
    launches = ops.launch_counts()["displacement_expm"]
    check(launches == len(shapes), f"displacement_expm launched {launches} "
          f"times on the main path, expected {len(shapes)}")
    rows = []
    for (d, cd), out in zip(shapes, outs):
        mu = mus[cd]
        mre, mim = mu.real.contiguous(), mu.imag.contiguous()
        plain = DE.displacement_expm_plain(mre, mim, d)
        err = max((out.real - plain[0]).abs().max().item(),
                  (out.imag - plain[1]).abs().max().item())
        held = DE.check_rounding((out.real, out.imag), plain, mre, mim, d)
        excess = held["of_bound"]
        check(held["beyond_bound"] == held["beyond_spacings"] == 0,
              f"displacement d={d} {cd}: the rounding check fails: {held}")
        eye = torch.eye(d, dtype=cd, device=device)
        check(torch.equal(out[0], eye), f"displacement d={d} {cd}: D(0) ≠ I")
        check(bool(torch.isfinite(torch.view_as_real(out)).all()),
              "displacement: not finite")
        planes = torch.view_as_real(torch.complex(
            *DE.displacement_expm(mre, mim, d)))
        check(torch.equal(torch.view_as_real(out).view(torch.uint8),
                          planes.view(torch.uint8)),
              f"displacement d={d} {cd}: the complex entry's bits differ "
              "from the planes entry's")
        del out, plain, planes
        torch.cuda.empty_cache()
        w = mre.element_size()
        dd = sum(min(j, k) + 1 for j in range(d) for k in range(d))
        moved = (2 * DISP_BATCH + 2 * DISP_BATCH * d * d) * w
        flops = 8 * dd * DISP_BATCH        # complex multiply-adds of L·U
        bound_ms, bound_by = _bound(moved, flops, PEAK_FP64_FLOPS
                                    if w == 8 else PEAK_FP32_FLOPS)
        kernel = lambda: DE.displacement_expm(mre, mim, d)  # noqa: E731
        main = lambda: ops.displacement_matrices(mu, d)  # noqa: E731
        parts = breakdown_of(main, ("displacement_kernel",), 1, reps=10)
        check(len(parts) == 1, f"displacement d={d} {cd}: the main path "
              f"runs {sorted(parts)}, not the complex entry alone")
        row = {"max_abs_err": err, "of_rounding_bound": excess,
               "ms": time_ms(kernel, 10),
               "device_ms": device_time_ms(kernel, 10, 1),
               "main_path_ms": time_ms(main, 10),
               "main_path_device_ms": sum(t * c for t, c in parts.values()),
               "plain_ms": time_ms(
                   lambda: DE.displacement_expm_plain(mre, mim, d), 3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "rounding_check": held,
               "shape": {"b": DISP_BATCH, "d": d, "dtype": str(mre.dtype)}}
        row["of_bound_device"] = bound_ms / row["device_ms"]
        print(f"displacement d={d} {mre.dtype}: ms={row['ms']:.4f} "
              f"(device {row['device_ms']:.4f}, "
              f"{row['of_bound_device']:.1%} of the bound) main path "
              f"ops.displacement_matrices ms={row['main_path_ms']:.4f} "
              f"(device {row['main_path_device_ms']:.4f}, {sorted(parts)}) "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}: {moved / 1e9:.4f} GB, {flops / 1e12:.5f} TFLOP) "
              f"max_abs_err={err:.3e} ({excess:.4f} of the rounding bound)",
              flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    del outs, mus, mu64, r, phi
    torch.cuda.empty_cache()
    subnormal = _displacement_subnormal(device)
    _phase("displacement", t0)
    return dict(rows[0], name="displacement_expm", route="cuda",
                source="src/repro_torch/kernels/csrc/displacement_expm.cu",
                replaces="src/repro/kernels/displacement_expm.py:108",
                launches=launches, other_shapes=rows[1:], subnormal_ranges=subnormal,
                library_note="no single PyTorch call computes the Zassenhaus "
                "product; torch.linalg.matrix_exp computes the exact D(μ), "
                "another function")


def _displacement_subnormal(device) -> list:
    """The kernel and its plain version on 2¹⁶ draws at d = 16 in each of
    ``SUBNORMAL_RANGES``, through ``displacement_expm.check_rounding``; the
    counts beyond each rule and the most subnormal spacings are printed
    and recorded, not held (an element beyond the bound whose exact value
    is normal is a fault of the kernel)."""
    from repro_torch.kernels import displacement_expm as DE

    rows = []
    for real, lo, hi, log in SUBNORMAL_RANGES:
        rng = np.random.default_rng(0)
        r = (np.exp(rng.uniform(np.log(lo), np.log(hi), 2 ** 16)) if log
             else rng.uniform(lo, hi, 2 ** 16))
        phi = rng.uniform(0, 2 * np.pi, r.size)
        mre, mim = (torch.from_numpy(a).to(real).to(device)
                    for a in (r * np.cos(phi), r * np.sin(phi)))
        got = DE.displacement_expm(mre, mim, 16)
        want = DE.displacement_expm_plain(mre, mim, 16)
        held = DE.check_rounding(got, want, mre, mim, 16)
        held.update(dtype=str(real), low=lo, high=hi)
        print(f"displacement subnormal range {real} |μ| in [{lo}, {hi}], 2¹⁶ "
              f"draws, d = 16: {json.dumps(held)}", flush=True)
        rows.append(held)
    print("displacement subnormal ranges: most subnormal spacings from the "
          f"exact value {max(h['spacings_kernel'] for h in rows):.6g} "
          f"(kernel), {max(h['spacings_plain'] for h in rows):.6g} (plain); "
          f"elements beyond the bound whose exact value is normal "
          f"{sum(h['beyond_bound'] for h in rows)}, beyond their spacings "
          f"{sum(h['beyond_spacings'] for h in rows)}", flush=True)
    return rows


def _flash_close(name, got, want, qkv, causal) -> dict:
    """fp32: within 1e-5 of the largest |out|; bf16: within
    ``flash_attention.rounding_bound`` elementwise.  Returns the max abs
    difference (and for bf16 its largest share of the bound)."""
    from repro_torch.kernels import flash_attention as FA

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {"max_abs_err": diff.max().item()}
    if want.dtype == torch.float32:
        ok = out["max_abs_err"] <= 1e-5 * max(1.0, w.abs().max().item())
    else:
        share = (diff / FA.rounding_bound(*qkv, causal=causal)).max().item()
        out["of_rounding_bound"] = share
        ok = share <= 1.0
    check(ok and bool(torch.isfinite(g).all()), f"{name}: kernel and plain "
          f"differ beyond the tolerance ({out})")
    return out


def _flash_row(name: str, q, k, v, causal: bool, shape: dict) -> dict:
    """The flash kernel against its plain version on (q, k, v), its time,
    the plain version's, ``F.scaled_dot_product_attention``'s and the
    bound (4·B·H·S·T·Dh operations, halved when causal, against Q, K, V
    and O once); printed and returned as a row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    close = _flash_close(name, FA.flash_attention(q, k, v, causal),
                         FA.flash_attention_plain(q, k, v, causal),
                         (q, k, v), causal)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    b, s, h, dh = q.shape
    t, w = k.shape[1], q.element_size()
    flops = 4 * b * h * s * t * dh // (2 if causal else 1)
    moved = (2 * q.numel() + k.numel() + v.numel()) * w
    bound_ms, bound_by = _bound(moved, flops, PEAK_BF16_FLOPS
                                if q.dtype == torch.bfloat16
                                else PEAK_FP32_FLOPS)
    row = {**close,
           "ms": time_ms(lambda: FA.flash_attention(q, k, v, causal), 5),
           "plain_ms": time_ms(
               lambda: FA.flash_attention_plain(q, k, v, causal), 3),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True), 5),
           "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape}
    print(f"{name}: ms={row['ms']:.3f} plain_ms={row['plain_ms']:.3f} "
          f"library_ms={row['library_ms']:.3f} bound_ms={bound_ms:.4f} "
          f"({bound_by}: {moved / 1e9:.4f} GB, {flops / 1e12:.4f} TFLOP; "
          f"{flops / row['ms'] / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / row['ms']:.1%} of the bound) {json.dumps(close)}",
          flush=True)
    return row


def phase_flash(device) -> list:
    """The flash kernel against its plain version at FLASH_CASES; returns
    one row per case (the first is granite-3-2b's prefill)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(23)
    rows = []
    for b, s, h, kvh, dh, dt, causal in FLASH_CASES:
        name = (f"flash B={b} S={s} H={h} KVH={kvh} Dh={dh} {dt} "
                f"{'causal' if causal else 'full'}")
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
                   for shape in ((b, s, h, dh), (b, s, kvh, dh),
                                 (b, s, kvh, dh)))
        rows.append(_flash_row(name, q, k, v, causal, {
            "b": b, "s": s, "t": s, "h": h, "kvh": kvh, "dh": dh,
            "dtype": str(dt), "causal": causal}))
        del q, k, v
        torch.cuda.empty_cache()
    _phase("flash", t0)
    return rows


def phase_lm(device) -> dict:
    """granite-3-2b at full width through the port's prefill and serve
    paths.  Returns the flash launches of one prefill and the wall times."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm, steps
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = configs.get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    ti = time.perf_counter()
    params = T.init_params(0, cfg, device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm: {LM_ARCH} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.dtype}: {n_params / 1e9:.3f} B parameters built in "
          f"{time.perf_counter() - ti:.3f} s", flush=True)
    gen = torch.Generator(device=device).manual_seed(29)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                         device=device)
    prefill = steps.make_prefill_step(cfg, kernels="auto")
    prefill(params, {"tokens": toks[:, :128]})          # warm-up
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before, read just after
    ops.reset_launches()
    tp = time.perf_counter()
    last = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tp
    launches = ops.launch_counts()
    print(f"lm: prefill B={LM_BATCH} S={LM_SEQ} in {prefill_s:.3f} s "
          f"({LM_BATCH * LM_SEQ / prefill_s:.0f} tokens/s); launches "
          f"{launches}", flush=True)
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in "
          f"one prefill, expected {cfg.n_layers}")
    tq = time.perf_counter()
    plain = steps.make_prefill_step(cfg, kernels="torch")(params,
                                                          {"tokens": toks})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - tq
    check(bool(torch.isfinite(last.float()).all()), "lm: logits not finite")
    rel = ((last.float() - plain.float()).abs().max()
           / plain.float().abs().max()).item()
    agree = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"lm: last-token logits flash vs plain attention: max rel diff "
          f"{rel:.3e} (tolerance {LM_LOGIT_TOL}), argmax agreement {agree}; "
          f"plain prefill {plain_s:.3f} s", flush=True)
    check(last.shape == (LM_BATCH, cfg.vocab) and rel <= LM_LOGIT_TOL,
          f"lm: prefill logits differ from the plain attention's ({rel:.3e})")
    del last, plain
    torch.cuda.empty_cache()

    short = toks[:, :16]
    full, _ = T.forward(params, short, cfg)            # flash kernel
    state = T.init_decode_state(cfg, LM_BATCH, 17, device)
    outs = []
    for t in range(short.shape[1]):                      # plain _sdpa
        logits, state = T.decode_step(params, short[:, t:t + 1], state, cfg)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    rel = ((dec.float() - full.float()).abs().max()
           / full.float().abs().max()).item()
    print(f"lm: decode vs forward on S=16: argmax agreement {agree:.4f}, "
          f"max rel diff {rel:.3e}", flush=True)
    check(rel <= LM_LOGIT_TOL,
          f"lm: decode differs from the forward (max rel diff {rel:.3e})")

    rng = np.random.default_rng(31)
    n, mx = SERVE["requests"], SERVE["max_new"]
    prompts = [(int(t), int(m)) for t, m in
               zip(rng.integers(0, cfg.vocab, n),
                   rng.integers(max(2, mx // 4), mx + 1, n))]
    ts = time.perf_counter()
    done = serve_lm.serve(cfg, params, prompts, SERVE["batch"], mx,
                          SERVE["cache_len"])
    serve_s = time.perf_counter() - ts
    total = sum(len(v) for v in done.values())
    check(sorted(done) == list(range(n)), f"lm: served {sorted(done)}")
    for rid, (_, limit) in enumerate(prompts):
        check(1 <= len(done[rid]) <= limit
              and all(0 <= t < cfg.vocab for t in done[rid]),
              f"lm: request {rid} got {done[rid]}")
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"lm: serve {n} requests, {total} tokens in {serve_s:.3f} s "
          f"({total / serve_s:.1f} tokens/s); peak memory {peak:.3f} GB",
          flush=True)
    ts = time.perf_counter()                        # again, warm
    again = serve_lm.serve(cfg, params, prompts, SERVE["batch"], mx,
                           SERVE["cache_len"], verbose=False)
    warm_s = time.perf_counter() - ts
    check(again == done, "lm: a second serve() gave other tokens")

    # one decode step at the serving batch: wall time against device time
    b = SERVE["batch"]
    caches = T.init_decode_state(cfg, b, SERVE["cache_len"], device).caches
    tok = torch.zeros((b, 1), dtype=torch.int32, device=device)
    pos = torch.arange(b, dtype=torch.int32, device=device)
    step = serve_lm.make_decode_fn(cfg)

    def one():
        step(params, tok, caches, pos)

    walls = []
    for _ in range(6):
        tw = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tw) * 1e3)
    step_ms = statistics.median(walls[1:])
    kernels = device_breakdown(one, reps=1)
    device_ms = sum(ms * c for ms, c in kernels.values())
    n_kernels = sum(v[1] for v in kernels.values())
    top = dict(list(kernels.items())[:4])
    print(f"lm: serve again (warm) in {warm_s:.3f} s ({total / warm_s:.1f} "
          f"tokens/s); one decode step at batch {b}: {step_ms:.3f} ms wall, "
          f"{device_ms:.3f} ms on the device in {n_kernels} kernels "
          f"(idle share {1 - device_ms / step_ms:.3f}); largest "
          f"{json.dumps(top)}", flush=True)
    del params, full, dec, state, caches
    torch.cuda.empty_cache()
    _phase("lm", t0)
    return {"flash_launches": launches["flash_attention"],
            "prefill_s": prefill_s, "plain_prefill_s": plain_s,
            "serve_s": serve_s, "serve_warm_s": warm_s,
            "serve_tokens": total, "decode_step_ms": step_ms,
            "decode_step_device_ms": device_ms,
            "decode_step_kernels": n_kernels, "peak_gb": peak}


def _moe_prompts(vocab: int) -> list:
    rng = np.random.default_rng(31)
    n, mx = SERVE["requests"], SERVE["max_new"]
    return [(int(t), int(m)) for t, m in
            zip(rng.integers(0, vocab, n),
                rng.integers(max(2, mx // 4), mx + 1, n))]


def _serve_and_step(cfg, params, tag: str, device, reps: int) -> dict:
    """``serve()`` of phase lm's requests cold and again warm (the same
    tokens), then one decode step at the serving batch: wall time against
    device time (torch.profiler over ``reps`` calls).  Returns the
    numbers, ``top`` the step's four largest kernels."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as T

    prompts = _moe_prompts(cfg.vocab)
    n, mx = SERVE["requests"], SERVE["max_new"]
    ts = time.perf_counter()
    done = serve_lm.serve(cfg, params, prompts, SERVE["batch"], mx,
                          SERVE["cache_len"])
    serve_s = time.perf_counter() - ts
    check(sorted(done) == list(range(n)), f"{tag}: served {sorted(done)}")
    for rid, (_, limit) in enumerate(prompts):
        check(1 <= len(done[rid]) <= limit
              and all(0 <= t < cfg.vocab for t in done[rid]),
              f"{tag}: request {rid} got {done[rid]}")
    ts = time.perf_counter()                        # again, warm
    again = serve_lm.serve(cfg, params, prompts, SERVE["batch"], mx,
                           SERVE["cache_len"], verbose=False)
    warm_s = time.perf_counter() - ts
    check(again == done, f"{tag}: a second serve() gave other tokens")

    b = SERVE["batch"]
    caches = T.init_decode_state(cfg, b, SERVE["cache_len"], device).caches
    tok = torch.zeros((b, 1), dtype=torch.int32, device=device)
    pos = torch.arange(b, dtype=torch.int32, device=device)
    step = serve_lm.make_decode_fn(cfg)

    def one():
        step(params, tok, caches, pos)

    walls = []
    for _ in range(6):
        tw = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tw) * 1e3)
    kernels = device_breakdown(one, reps=reps)
    return {"served": done, "serve_s": serve_s, "serve_warm_s": warm_s,
            "serve_tokens": sum(len(v) for v in done.values()),
            "decode_step_ms": statistics.median(walls[1:]),
            "decode_step_device_ms": sum(ms * c
                                         for ms, c in kernels.values()),
            "decode_step_kernels": sum(v[1] for v in kernels.values()),
            "top": dict(list(kernels.items())[:4])}


def _serve_line(tag: str, r: dict) -> str:
    n, b = SERVE["requests"], SERVE["batch"]
    total, step_ms = r["serve_tokens"], r["decode_step_ms"]
    return (f"{tag}: serve {n} requests, {total} tokens in {r['serve_s']:.3f}"
            f" s cold ({total / r['serve_s']:.1f} tokens/s), "
            f"{r['serve_warm_s']:.3f} s warm ({total / r['serve_warm_s']:.1f}"
            f" tokens/s); one decode step at batch {b}: {step_ms:.3f} ms "
            f"wall, {r['decode_step_device_ms']:.3f} ms on the device in "
            f"{r['decode_step_kernels']} kernels (idle share "
            f"{1 - r['decode_step_device_ms'] / step_ms:.3f})")


def _moe_model(device, arch: str, depth: int, batch: int, seq: int) -> dict:
    """One MoE architecture at its published width, ``depth`` layers,
    through the port's entry points.  Returns its numbers."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    tag = f"moe {arch}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    ti = time.perf_counter()
    params = T.init_params(0, cfg, device)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - ti
    n_params = sum(p.numel() for p in params.parameters())
    attn = "MLA" if cfg.use_mla else f"GQA {cfg.n_heads}/{cfg.n_kv_heads}"
    print(f"{tag}: {depth} of {full.n_layers} layers, d_model {cfg.d_model}, "
          f"{attn}, head_dim {cfg.hd}, {cfg.n_experts} + "
          f"{cfg.n_shared_experts} experts, top-{cfg.top_k}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}: {n_params / 1e9:.3f} B "
          f"parameters ({n_params * 2 / 1e9:.2f} GB) built in {built_s:.3f} s",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(29)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=device)
    T.forward(params, toks[:, :128], cfg)                      # warm-up
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before, read just after
    layer_aux: list = []
    ops.reset_launches()
    tp = time.perf_counter()
    logits, lb_sum = T.forward(params, toks, cfg, kernels="auto",
                               layer_aux=layer_aux)
    last = logits[:, -1, :].clone()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tp
    launches = ops.launch_counts()
    del logits
    want_flash = 0 if cfg.use_mla else cfg.n_layers
    drop = [float(a["drop_frac"]) for a in layer_aux]
    lb = [float(a["lb_loss"]) for a in layer_aux]
    cap = MOE._capacity(seq, cfg.moe_cfg())
    print(f"{tag}: prefill B={batch} S={seq} in {prefill_s:.3f} s "
          f"({batch * seq / prefill_s:.0f} tokens/s); capacity {cap} a row; "
          f"drop_frac by layer {drop}, lb_loss by layer {lb} (sum "
          f"{float(lb_sum):.4f}); launches {launches}", flush=True)
    check(launches["flash_attention"] == want_flash,
          f"{tag}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {want_flash}")
    check(last.shape == (batch, cfg.vocab)
          and bool(torch.isfinite(last.float()).all()),
          f"{tag}: prefill logits {tuple(last.shape)} not finite or shaped "
          f"(B, V)")
    out = {"arch": arch, "layers": depth, "params_b": n_params / 1e9,
           "built_s": built_s, "prefill_s": prefill_s, "capacity": cap,
           "drop_frac": drop, "lb_loss": lb,
           "flash_launches": launches["flash_attention"]}
    if not cfg.use_mla:             # the same prefill, plain attention
        tq = time.perf_counter()
        plain = steps.make_prefill_step(cfg, kernels="torch")(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        out["plain_prefill_s"] = time.perf_counter() - tq
        rel = ((last.float() - plain.float()).abs().max()
               / plain.float().abs().max()).item()
        agree = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
        print(f"{tag}: last-token logits flash vs plain attention: max rel "
              f"diff {rel:.3e} (tolerance {LM_LOGIT_TOL}), argmax agreement "
              f"{agree}; plain prefill {out['plain_prefill_s']:.3f} s",
              flush=True)
        check(rel <= LM_LOGIT_TOL, f"{tag}: prefill logits differ from the "
              f"plain attention's ({rel:.3e})")
        out["flash_vs_plain_rel"] = rel
        del plain
    torch.cuda.empty_cache()

    # decode against the forward, with a capacity no token overflows: at
    # the published 1.25 a 16-token row gets capacity 1 and the forward
    # drops tokens that a one-token decode step never drops.  A route may
    # still differ where the router's k-th and (k+1)-th experts are a near
    # tie: the forward's attention (the flash kernel: fp32 scores, P in
    # bf16) and the decode's (``_sdpa``: scores rounded to bf16, as the
    # reference's) differ by bf16 roundings, and a one-ulp change of x can
    # swap them.  The logits are held to the tolerance where every layer
    # routed a token alike; tokens routed otherwise are counted and held
    # to at most an eighth, and the argmax agreement to the reference's
    # own decode-vs-prefill criterion (> 0.9, tests/test_models.py)
    dcfg = dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)
    short = toks[:, :MOE_DECODE_SEQ]
    fwd_aux: list = []
    fwd, _ = T.forward(params, short, dcfg, layer_aux=fwd_aux)
    state = T.init_decode_state(dcfg, batch, MOE_DECODE_SEQ + 1, device)
    outs, dec_aux = [], []
    for t in range(MOE_DECODE_SEQ):
        step_aux: list = []
        step_logits, state = T.decode_step(params, short[:, t:t + 1], state,
                                           dcfg, layer_aux=step_aux)
        outs.append(step_logits[:, 0])
        dec_aux.append(step_aux)
    dec = torch.stack(outs, dim=1)
    other = torch.stack([                            # (L, B, S)
        (torch.cat([st[layer]["expert_ids"] for st in dec_aux], dim=1)
         .sort(-1).values != a["expert_ids"].sort(-1).values).any(-1)
        for layer, a in enumerate(fwd_aux)])
    # a token is compared if no layer routed it otherwise and no earlier
    # token of its row was routed otherwise before the last layer (its
    # state reaches later tokens through the next layers' attention)
    early = other[:-1].any(0).to(torch.int32).cummax(dim=1).values.bool()
    alike = ~(other.any(0) | early)
    flipped = int(other.any(0).sum())
    agree = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    diff = (dec.float() - fwd.float()).abs().amax(-1)          # (B, S)
    scale = fwd.float().abs().max()
    rel = (diff.max() / scale).item()
    rel_alike = ((diff * alike).max() / scale).item()
    print(f"{tag}: decode vs forward on S={MOE_DECODE_SEQ} at capacity_factor "
          f"{dcfg.capacity_factor} (= n_experts / top_k, so the forward "
          f"drops no token; at the published {cfg.capacity_factor} its "
          f"capacity is {MOE._capacity(MOE_DECODE_SEQ, cfg.moe_cfg())}): "
          f"{flipped} of {alike.numel()} tokens routed otherwise in some "
          f"layer (near ties); max rel diff {rel_alike:.3e} on the "
          f"{int(alike.sum())} tokens routed alike (tolerance "
          f"{LM_LOGIT_TOL}), {rel:.3e} on all; argmax agreement "
          f"{agree:.4f}", flush=True)
    check(rel_alike <= LM_LOGIT_TOL, f"{tag}: decode differs from the "
          f"forward on tokens routed alike (max rel diff {rel_alike:.3e})")
    check(flipped * 8 <= alike.numel() and agree > 0.9,
          f"{tag}: decode routed {flipped} of {alike.numel()} tokens "
          f"otherwise than the forward, argmax agreement {agree}")
    out.update(decode_vs_forward_rel=rel_alike, decode_vs_forward_rel_all=rel,
               decode_routed_otherwise=flipped, decode_argmax_agree=agree)
    one_device = {"last": last, "decode": dec}
    del fwd, state, outs, fwd_aux, dec_aux
    torch.cuda.empty_cache()

    numbers = _serve_and_step(cfg, params, tag, device, reps=3)
    top = numbers.pop("top")
    served = numbers.pop("served")
    expert_gb = (cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
                 * params["embed"].element_size() / 1e9)
    bound_ms = expert_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"{_serve_line(tag, numbers)}; it reads every routed expert, "
          f"{expert_gb:.2f} GB: {bound_ms:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{bound_ms / numbers['decode_step_device_ms']:.1%} of the device "
          f"time; largest {json.dumps(top)}; peak memory {peak:.3f} GB",
          flush=True)
    out.update(numbers, expert_gb_a_step=expert_gb, expert_bound_ms=bound_ms,
               peak_gb=peak)
    one_device.update(served=served, serve_s=numbers["serve_s"],
                      step_ms=numbers["decode_step_ms"],
                      step_device_ms=numbers["decode_step_device_ms"],
                      step_kernels=numbers["decode_step_kernels"])
    out["mesh_1x1"] = _moe_sharded(device, cfg, dcfg, params, toks, short,
                                   one_device, tag)
    del params, one_device
    torch.cuda.empty_cache()
    return out


def _moe_sharded(device, cfg, dcfg, params, toks, short, one: dict,
                 tag: str) -> dict:
    """The same model through the sharded path (ROADMAP §1 row 22) on a 1×1
    ("data", "model") mesh over a one-rank NCCL group: the rank's tiles
    (``steps.shard_params``; on one rank a tile is the weight itself, so
    the 38.8 / 49.7 GB are held once), the mesh declared, then the prefill
    (the rank's batch rows through ``transformer.forward``'s sharded
    layers: the expert-parallel MoE, MLA over the heads, kimi-k2's GQA
    through ``_attn_apply_tp`` and the flash kernel), the decode against
    the forward of the one-device check above (its state from
    ``steps.shard_state``) and ``serve()``'s greedy tokens, each held bit
    for bit against the one-device path's; kimi-k2's sharded prefill
    launches ``flash_attention`` once a layer (the wrapper's counter)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm, steps
    from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                         make_host_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes

    mtag = f"{tag} mesh 1x1"
    t0 = time.perf_counter()
    created = init_distributed(device)
    try:
        mesh = make_host_mesh(1, device)
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        psh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                    fsdp=False)
        rp = steps.shard_params(params, psh, mesh)
        same = all(a.data_ptr() == b.data_ptr() for a, b in
                   zip(rp.parameters(), params.parameters()))
        check(same, f"{mtag}: a one-rank tile is a copy, not the weight")
        tp = T._tp_layout(rp, cfg)
        batch = {"tokens": toks}
        local = steps.shard_batch(batch, steps.batch_shardings(mesh, batch),
                                  mesh)
        torch.cuda.synchronize()
        ops.reset_launches()
        tp_s = time.perf_counter()
        logits, _ = T.forward(rp, local["tokens"], cfg, kernels="auto")
        last = logits[:, -1, :].clone()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - tp_s
        launches = ops.launch_counts()
        del logits
        want_flash = 0 if cfg.use_mla else cfg.n_layers
        prefill_equal = bool(torch.equal(last, one["last"]))
        print(f"{mtag}: layout experts={tp.experts} heads={tp.heads} "
              f"kv_heads={tp.kv_heads} ffn={tp.ffn}; prefill B="
              f"{toks.shape[0]} S={toks.shape[1]} in {prefill_s:.3f} s, "
              f"last-token logits equal to the one-device prefill's bit for "
              f"bit: {prefill_equal}; launches {launches}", flush=True)
        check(prefill_equal, f"{mtag}: the sharded prefill's logits differ "
              "from the one-device prefill's")
        check(launches["flash_attention"] == want_flash,
              f"{mtag}: flash_attention launched "
              f"{launches['flash_attention']} times in the sharded prefill, "
              f"expected {want_flash}")
        del last
        whole = T.init_decode_state(dcfg, short.shape[0], MOE_DECODE_SEQ + 1,
                                    device)
        state = steps.shard_state(whole, steps.cache_shardings(
            mesh, dcfg, whole.caches), mesh)
        specs = {k: tuple(v) for k, v in state.shardings.items()}
        outs = []
        for t in range(MOE_DECODE_SEQ):
            step_logits, state = T.decode_step(rp, short[:, t:t + 1], state,
                                               dcfg)
            outs.append(step_logits[:, 0])
        dec = torch.stack(outs, dim=1)
        decode_equal = bool(torch.equal(dec, one["decode"]))
        del state, whole, outs, dec
        torch.cuda.empty_cache()
        prompts = _moe_prompts(cfg.vocab)
        ts = time.perf_counter()
        served = serve_lm.serve(cfg, rp, prompts, SERVE["batch"],
                                SERVE["max_new"], SERVE["cache_len"],
                                verbose=False)
        serve_s = time.perf_counter() - ts
        served_equal = served == one["served"]
        step = _decode_step_numbers(cfg, rp, device)
        print(f"{mtag}: decode of S={MOE_DECODE_SEQ} (cache specs {specs}) "
              f"equal to the one-device decode's logits bit for bit: "
              f"{decode_equal}; serve() of {len(prompts)} requests in "
              f"{serve_s:.3f} s (one device: {one['serve_s']:.3f} s cold), "
              f"its tokens equal to the one-device serve()'s: "
              f"{served_equal}; one decode step at batch {SERVE['batch']}: "
              f"{step['wall_ms']:.3f} ms wall, {step['device_ms']:.3f} ms "
              f"on the device in {step['kernels']} kernels (one device: "
              f"{one['step_ms']:.3f} ms wall, {one['step_device_ms']:.3f} ms "
              f"in {one['step_kernels']}); {time.perf_counter() - t0:.1f} s "
              f"[{nvidia_smi()}]", flush=True)
        check(decode_equal, f"{mtag}: the sharded decode's logits differ "
              "from the one-device decode's")
        check(served_equal, f"{mtag}: the sharded serve() gave other tokens")
        del rp
    finally:
        clear_mesh_axes()
        if created:
            dist.destroy_process_group()
    return {"prefill_s": prefill_s, "prefill_equal": prefill_equal,
            "flash_launches": launches["flash_attention"],
            "decode_equal": decode_equal, "serve_s": serve_s,
            "served_equal": served_equal, "decode_step": step}


def _decode_step_numbers(cfg, params, device, reps: int = 3) -> dict:
    """One decode step at the serving batch, as ``_serve_and_step`` times
    it: the median wall of 5 after one, the device time and kernels."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as T

    b = SERVE["batch"]
    caches = T.init_decode_state(cfg, b, SERVE["cache_len"], device).caches
    tok = torch.zeros((b, 1), dtype=torch.int32, device=device)
    pos = torch.arange(b, dtype=torch.int32, device=device)
    step = serve_lm.make_decode_fn(cfg)

    def one():
        step(params, tok, caches, pos)

    walls = []
    for _ in range(6):
        tw = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tw) * 1e3)
    kernels = device_breakdown(one, reps=reps)
    return {"wall_ms": statistics.median(walls[1:]),
            "device_ms": sum(ms * c for ms, c in kernels.values()),
            "kernels": sum(v[1] for v in kernels.values())}


def phase_moe(device) -> dict:
    """deepseek-v3 (MLA, 2 layers) and kimi-k2 (GQA at head_dim 112, one
    layer) at full width through the port's entry points: prefill, decode
    against the forward, ``serve()`` cold and warm, one decode step
    profiled.  Returns each model's numbers."""
    t0 = time.perf_counter()
    out = {arch: _moe_model(device, arch, depth, b, s)
           for arch, depth, b, s in MOE_RUNS}
    _phase("moe", t0)
    return out


def _rope_on_the_card(device) -> dict:
    """rope's tables on the card against the CPU's (bit for bit) and
    against the card machine's glibc ``sinf``/``cosf``, the functions the
    reference's XLA calls (its FMA build rounds a double sum otherwise in
    rare cases: those are counted)."""
    import ctypes
    import ctypes.util

    from repro_torch.models import common as C

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (libm.sinf, libm.cosf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    pos = torch.arange(LM_SEQ)[None]
    out = {"angles": 0, "card_vs_cpu": 0, "vs_glibc": 0}
    for dh in ROPE_HEAD_DIMS:
        card = [t.cpu() for t in C.rope_tables(pos.to(device), dh)]
        cpu = C.rope_tables(pos, dh)
        out["card_vs_cpu"] += sum(int((a != b).sum())
                                  for a, b in zip(card, cpu))
        ang = (pos[..., None].float()
               * C.rope_inv_freq(dh, 10000.0, torch.device("cpu"))).ravel()
        glibc = [torch.tensor([fn(a) for a in ang.tolist()],
                              dtype=torch.float32)
                 for fn in (libm.cosf, libm.sinf)]
        out["vs_glibc"] += sum(int((c.ravel() != g).sum())
                               for c, g in zip(card, glibc))
        out["angles"] += 2 * ang.numel()
    print(f"ssm: rope tables on the card at Dh {ROPE_HEAD_DIMS}, positions "
          f"0-{LM_SEQ - 1}: {out['card_vs_cpu']} of {out['angles']} sin/cos "
          f"values differ from the CPU's, {out['vs_glibc']} from glibc's "
          f"sinf/cosf (double roundings)", flush=True)
    check(out["card_vs_cpu"] == 0, f"ssm: rope tables on the card differ "
          f"from the CPU's: {out}")
    return out


def _ssd_check(params, cfg, device) -> dict:
    """One layer's chunked SSD at full width in fp32 on S = SSD_CHECK_SEQ
    against the decode recurrence, token by token: y and the final state
    (the only check of the inter-chunk loop at the real width)."""
    from repro_torch.models import mamba2 as M2

    scfg = cfg.ssm_cfg()
    lp = {k: v.float() for k, v in params["layers"][0]["mamba"].items()}
    gen = torch.Generator(device=device).manual_seed(37)
    x = torch.randn((1, SSD_CHECK_SEQ, cfg.d_model), generator=gen,
                    device=device)
    z = x @ lp["w_in"]
    xi, _, b, c, dtr = M2._split_proj(z, scfg)
    shape = (1, SSD_CHECK_SEQ)
    dt = torch.logaddexp(dtr + lp["dt_bias"], torch.zeros((), device=device))
    _, final = M2._ssd_chunked(
        xi.reshape(*shape, scfg.heads, scfg.d_head), dt,
        -torch.exp(lp["A_log"]), b.reshape(*shape, 1, scfg.d_state),
        c.reshape(*shape, 1, scfg.d_state), scfg)
    full, _ = M2.mamba2_apply(lp, x, scfg)
    st = M2.init_ssm_state(1, scfg, torch.float32, device)
    steps = []
    for t in range(SSD_CHECK_SEQ):
        out, st = M2.mamba2_apply(lp, x[:, t:t + 1], scfg, st)
        steps.append(out)
    torch.cuda.synchronize()
    y_rel = ((torch.cat(steps, 1) - full).abs().max()
             / full.abs().max()).item()
    st_rel = ((st.state - final).abs().max() / final.abs().max()).item()
    ln = M2.chunk_len(SSD_CHECK_SEQ, scfg.chunk)
    print(f"ssm: one layer's SSD in fp32 on S={SSD_CHECK_SEQ} "
          f"({SSD_CHECK_SEQ // ln} chunks of {ln}) against "
          f"{SSD_CHECK_SEQ} decode steps: max rel diff {y_rel:.3e} in the "
          f"block's output, {st_rel:.3e} in the final state (tolerance "
          f"{SSD_TOL})", flush=True)
    check(y_rel <= SSD_TOL and st_rel <= SSD_TOL and bool(
        torch.isfinite(full).all()), f"ssm: the chunked SSD differs from the "
          f"decode recurrence (y {y_rel:.3e}, state {st_rel:.3e})")
    return {"y_rel": y_rel, "state_rel": st_rel}


def _decode_vs_forward(params, cfg, short, device) -> tuple:
    """Step-by-step decode against the full forward on ``short``: (max
    relative difference of the logits, argmax agreement, the decode's
    logits (B, S, V) in the model's dtype)."""
    from repro_torch.models import transformer as T

    full, _ = T.forward(params, short, cfg)
    state = T.init_decode_state(cfg, short.shape[0], short.shape[1] + 1,
                                device)
    outs = []
    for t in range(short.shape[1]):
        logits, state = T.decode_step(params, short[:, t:t + 1], state, cfg)
        outs.append(logits[:, 0])
    raw = torch.stack(outs, dim=1)
    dec, full = raw.float(), full.float()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    return ((dec - full).abs().max().item() / full.abs().max().item(), agree,
            raw)


def _block_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _layerwise_flash(params, cfg, toks, device) -> list:
    """The hybrid's prefill walked block by block: at each application of
    the shared block, its attention's output (after ``wo``) through the
    flash kernel against the plain attention's on the same input (the walk
    goes on with the kernel's block).  Returns each application's
    relative difference."""
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    positions = torch.arange(toks.shape[1], device=device)[None, :]
    x = params["embed"][toks]
    out = []
    for layer, lp in enumerate(params["layers"]):
        h, _ = M2.mamba2_apply(lp["mamba"], rms_norm(x, lp["ln"]),
                               cfg.ssm_cfg())
        x = x + h
        if T._is_attn(cfg, layer):
            shared = params["shared_attn"]
            xn = rms_norm(x, shared["ln1"])
            got, want = (A.attn_apply(shared["attn"], xn, cfg.attn_cfg(),
                                      positions, kernels=k)[0]
                         for k in ("auto", "torch"))
            out.append(_block_rel(got, want))
            x, _ = T._dense_block(shared, x, cfg, positions)
    return out


def _layerwise_decode(params, cfg, short, device) -> list:
    """Each block's decode steps against its forward on the forward's own
    input (teacher forced, so no layer sees another's roundings): per
    Mamba2 layer its output, per application of the hybrid's shared block
    its attention's output (after ``wo``; the block's MLP is the same
    function in both), the largest difference relative to the largest
    |output|."""
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    b, s = short.shape
    scfg = cfg.ssm_cfg()
    positions = torch.arange(s, device=device)[None, :]
    x = params["embed"][short]
    out = []
    for layer, lp in enumerate(params["layers"]):
        xn = rms_norm(x, lp["ln"])
        h, _ = M2.mamba2_apply(lp["mamba"], xn, scfg)
        st = M2.init_ssm_state(b, scfg, cfg.dtype, device)
        steps = []
        for t in range(s):
            ht, st = M2.mamba2_apply(lp["mamba"], xn[:, t:t + 1], scfg, st)
            steps.append(ht)
        out.append(_block_rel(torch.cat(steps, 1), h))
        x = x + h
        if cfg.family == "hybrid" and T._is_attn(cfg, layer):
            shared = params["shared_attn"]
            xn = rms_norm(x, shared["ln1"])
            want, _ = A.attn_apply(shared["attn"], xn, cfg.attn_cfg(),
                                   positions)
            kv = torch.zeros((b, s, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype,
                             device=device)
            cache = A.KVCache(kv, kv.clone(), torch.zeros(
                (), dtype=torch.int32, device=device))
            steps = []
            for t in range(s):
                ht, cache = A.attn_apply(shared["attn"], xn[:, t:t + 1],
                                         cfg.attn_cfg(),
                                         positions[:, t:t + 1], cache)
                steps.append(ht)
            out.append(_block_rel(torch.cat(steps, 1), want))
            x, _ = T._dense_block(shared, x, cfg, positions)
    return out


def _ssm_model(device, arch: str) -> dict:
    """One SSM or hybrid architecture at full depth and published width
    through the port's entry points.  Returns its numbers."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T

    cfg = configs.get_config(arch)
    tag = f"ssm {arch}"
    scfg = cfg.ssm_cfg()
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    ti = time.perf_counter()
    params = T.init_params(0, cfg, device)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - ti
    n_params = sum(p.numel() for p in params.parameters())
    shared = (f", the shared attention ({cfg.n_heads}/{cfg.n_kv_heads} "
              f"heads, head_dim {cfg.hd}) + MLP (d_ff {cfg.d_ff}) after "
              f"each layer l with l % {cfg.attn_every} = "
              f"{cfg.attn_every - 1} ({n_attn} times)"
              if n_attn else "")
    print(f"{tag}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"{scfg.heads} heads of {scfg.d_head}, state {scfg.d_state}"
          f"{shared}, vocab {cfg.vocab}, {cfg.dtype}: {n_params / 1e9:.3f} B "
          f"parameters ({n_params * 2 / 1e9:.2f} GB) built in {built_s:.3f} s",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(29)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                         device=device)
    prefill = steps.make_prefill_step(cfg, kernels="auto")
    prefill(params, {"tokens": toks[:, :128]})          # warm-up
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before, read just after
    ops.reset_launches()
    tp = time.perf_counter()
    last = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tp
    launches = ops.launch_counts()
    ln = M2.chunk_len(LM_SEQ, scfg.chunk)
    print(f"{tag}: prefill B={LM_BATCH} S={LM_SEQ} ({LM_SEQ // ln} "
          f"chunks of {ln}) in {prefill_s:.3f} s "
          f"({LM_BATCH * LM_SEQ / prefill_s:.0f} tokens/s); launches "
          f"{launches}", flush=True)
    check(launches["flash_attention"] == n_attn,
          f"{tag}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {n_attn}")
    check(last.shape == (LM_BATCH, cfg.vocab)
          and bool(torch.isfinite(last.float()).all()),
          f"{tag}: prefill logits {tuple(last.shape)} not finite or shaped "
          f"(B, V)")
    one_device = {"last": last.clone()}
    out = {"arch": arch, "layers": cfg.n_layers, "params_b": n_params / 1e9,
           "built_s": built_s, "prefill_s": prefill_s,
           "flash_launches": launches["flash_attention"]}
    if n_attn:                      # the same prefill, plain attention
        # the whole model's logits are printed; each shared-block
        # application is held on its own input (a random-weight Mamba2
        # stack amplifies the kernel's bf16 roundings with depth, as
        # below for decode)
        tq = time.perf_counter()
        plain = steps.make_prefill_step(cfg, kernels="torch")(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        out["plain_prefill_s"] = time.perf_counter() - tq
        rel = ((last.float() - plain.float()).abs().max()
               / plain.float().abs().max()).item()
        agree = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
        del plain
        torch.cuda.empty_cache()
        block_rel = _layerwise_flash(params, cfg, toks, device)
        print(f"{tag}: last-token logits flash vs plain attention through "
              f"all {cfg.n_layers} layers: max rel diff {rel:.3e}, argmax "
              f"agreement {agree} (printed); each of the {len(block_rel)} "
              f"shared-block applications on its own input: max rel diff "
              f"{max(block_rel):.3e} (tolerance {LM_LOGIT_TOL}), median "
              f"{statistics.median(block_rel):.3e}; plain prefill "
              f"{out['plain_prefill_s']:.3f} s", flush=True)
        check(max(block_rel) <= LM_LOGIT_TOL, f"{tag}: a shared-block "
              f"application through the flash kernel differs from the "
              f"plain attention's ({max(block_rel):.3e})")
        out.update(flash_vs_plain_rel=rel, flash_vs_plain_agree=agree,
                   flash_vs_plain_block_rel=max(block_rel))
    del last
    torch.cuda.empty_cache()

    # decode against the forward.  A random-weight Mamba2 stack amplifies
    # roundings with depth (at mamba2's width and 8 layers on the CPU the
    # reference's own bf16 decode and forward differ by 0.093 of the
    # logits' scale, the port's by 0.10; at 48 layers on the card the
    # port's differ by 0.98 in bf16 and 0.053 in fp32), so each layer's
    # decode is held against its forward on the forward's own input, and
    # the whole model's logits are printed, their fp32 argmax agreement
    # held to the reference's decode-vs-prefill criterion (> 0.9)
    short = toks[:, :MOE_DECODE_SEQ]
    layer_rel = _layerwise_decode(params, cfg, short, device)
    print(f"{tag}: each layer's decode against its forward on the "
          f"forward's input, S={MOE_DECODE_SEQ}, {cfg.dtype}: max rel diff "
          f"{max(layer_rel):.3e} over {len(layer_rel)} blocks (tolerance "
          f"{LM_LOGIT_TOL}), median {statistics.median(layer_rel):.3e}",
          flush=True)
    check(max(layer_rel) <= LM_LOGIT_TOL, f"{tag}: a layer's decode differs "
          f"from its forward (max rel diff {max(layer_rel):.3e})")
    out["decode_vs_forward_layer_rel"] = max(layer_rel)
    for dt in (cfg.dtype, torch.float32):
        dcfg = dataclasses.replace(cfg, dtype=dt)
        dparams = params if dt == cfg.dtype else T.init_params(0, dcfg,
                                                               device)
        rel, agree, dec = _decode_vs_forward(dparams, dcfg, short, device)
        key = "fp32" if dt == torch.float32 else "bf16"
        if dt == cfg.dtype:
            one_device["decode"] = dec
        del dec
        print(f"{tag}: decode vs forward through all {cfg.n_layers} layers "
              f"on S={MOE_DECODE_SEQ} in {dt}: argmax agreement {agree:.4f}"
              f", max rel diff {rel:.3e}", flush=True)
        check(key == "bf16" or agree > 0.9, f"{tag}: fp32 decode and "
              f"forward agree on {agree} of the argmaxes")
        out.update({f"decode_vs_forward_rel_{key}": rel,
                    f"decode_argmax_agree_{key}": agree})
        del dparams
        torch.cuda.empty_cache()
    out["ssd"] = _ssd_check(params, cfg, device)

    numbers = _serve_and_step(cfg, params, tag, device, reps=3)
    top = numbers.pop("top")
    served = numbers.pop("served")
    scfg = cfg.ssm_cfg()
    state_gb = (cfg.n_layers * SERVE["batch"] * scfg.heads * scfg.d_head
                * scfg.d_state * 4 / 1e9)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"{_serve_line(tag, numbers)}; largest {json.dumps(top)}; the SSM "
          f"state at batch {SERVE['batch']} {state_gb:.3f} GB; peak memory "
          f"{peak:.3f} GB", flush=True)
    out.update(numbers, ssm_state_gb=state_gb, peak_gb=peak)
    one_device.update(served=served, serve_s=numbers["serve_s"],
                      step_ms=numbers["decode_step_ms"],
                      step_device_ms=numbers["decode_step_device_ms"],
                      step_kernels=numbers["decode_step_kernels"])
    out["mesh_1x1"] = _ssm_sharded(device, cfg, params, toks, short,
                                   one_device, tag, n_attn)
    del params, one_device
    torch.cuda.empty_cache()
    return out


def _ssm_sharded(device, cfg, params, toks, short, one: dict, tag: str,
                 n_attn: int) -> dict:
    """The same model through the sharded path (ROADMAP §1 row 22) on a 1×1
    ("data", "model") mesh over a one-rank NCCL group: the rank's tiles
    (``steps.shard_params``; on one rank a tile is the weight itself, and
    ``w_in``'s part-wise cut is the whole leaf in its own order), the mesh
    declared, then ``make_prefill_step`` on the rank's batch rows (each
    Mamba2 layer through ``mamba2_apply``'s sharded branch: ``_rank_proj``,
    the B/C all-gather and the norm's all-reduce over the one rank, the
    ``w_out`` sum an identity there; zamba2's shared block through
    ``_attn_apply_tp`` and the flash kernel, counted by the wrapper:
    ``n_attn`` launches), the decode against the forward
    of the one-device check above (its state from ``steps.shard_state``:
    the SSM state's tile its heads) and ``serve()``'s greedy tokens, each
    held bit for bit against the one-device path's, and one decode step
    profiled, its device time held within ``MESH_STEP_TOL`` of one
    device's."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm, steps
    from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                         make_host_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes

    mtag = f"{tag} mesh 1x1"
    t0 = time.perf_counter()
    created = init_distributed(device)
    try:
        mesh = make_host_mesh(1, device)
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        psh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                    fsdp=False)
        rp = steps.shard_params(params, psh, mesh)
        same = all(a.data_ptr() == b.data_ptr() for a, b in
                   zip(rp.parameters(), params.parameters()))
        check(same, f"{mtag}: a one-rank tile is a copy, not the weight")
        tp = T._tp_layout(rp, cfg)
        batch = {"tokens": toks}
        local = steps.shard_batch(batch, steps.batch_shardings(mesh, batch),
                                  mesh)
        prefill = steps.make_prefill_step(cfg, kernels="auto")
        torch.cuda.synchronize()
        ops.reset_launches()
        tp_s = time.perf_counter()
        last = prefill(rp, local)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - tp_s
        launches = ops.launch_counts()
        prefill_equal = bool(torch.equal(last, one["last"]))
        print(f"{mtag}: layout ssm={tp.ssm} heads={tp.heads} "
              f"kv_heads={tp.kv_heads} ffn={tp.ffn}; prefill B="
              f"{toks.shape[0]} S={toks.shape[1]} in {prefill_s:.3f} s, "
              f"last-token logits equal to the one-device prefill's bit for "
              f"bit: {prefill_equal}; launches {launches}", flush=True)
        check(prefill_equal, f"{mtag}: the sharded prefill's logits differ "
              "from the one-device prefill's")
        check(launches["flash_attention"] == n_attn,
              f"{mtag}: flash_attention launched "
              f"{launches['flash_attention']} times in the sharded prefill, "
              f"expected {n_attn}")
        del last
        whole = T.init_decode_state(cfg, short.shape[0], short.shape[1] + 1,
                                    device)
        state = steps.shard_state(whole, steps.cache_shardings(
            mesh, cfg, whole.caches), mesh)
        specs = {k: tuple(v) for k, v in state.shardings.items()}
        outs = []
        for t in range(short.shape[1]):
            step_logits, state = T.decode_step(rp, short[:, t:t + 1], state,
                                               cfg)
            outs.append(step_logits[:, 0])
        decode_equal = bool(torch.equal(torch.stack(outs, dim=1),
                                        one["decode"]))
        del state, whole, outs
        torch.cuda.empty_cache()
        prompts = _moe_prompts(cfg.vocab)
        ts = time.perf_counter()
        served = serve_lm.serve(cfg, rp, prompts, SERVE["batch"],
                                SERVE["max_new"], SERVE["cache_len"],
                                verbose=False)
        serve_s = time.perf_counter() - ts
        served_equal = served == one["served"]
        step = _decode_step_numbers(cfg, rp, device)
        rel = step["device_ms"] / one["step_device_ms"] - 1
        print(f"{mtag}: decode of S={short.shape[1]} (cache specs {specs}) "
              f"equal to the one-device decode's logits bit for bit: "
              f"{decode_equal}; serve() of {len(prompts)} requests in "
              f"{serve_s:.3f} s (one device: {one['serve_s']:.3f} s cold), "
              f"its tokens equal to the one-device serve()'s: "
              f"{served_equal}; one decode step at batch {SERVE['batch']}: "
              f"{step['wall_ms']:.3f} ms wall, {step['device_ms']:.3f} ms "
              f"on the device in {step['kernels']} kernels (one device: "
              f"{one['step_ms']:.3f} ms wall, {one['step_device_ms']:.3f} ms "
              f"in {one['step_kernels']}; device {rel:+.2%}, tolerance "
              f"{MESH_STEP_TOL:.0%}); {time.perf_counter() - t0:.1f} s "
              f"[{nvidia_smi()}]", flush=True)
        check(decode_equal, f"{mtag}: the sharded decode's logits differ "
              "from the one-device decode's")
        check(served_equal, f"{mtag}: the sharded serve() gave other tokens")
        check(abs(rel) <= MESH_STEP_TOL, f"{mtag}: the decode step's device "
              f"time {step['device_ms']:.3f} ms differs from one device's "
              f"{one['step_device_ms']:.3f} by {rel:+.2%}")
        del rp
    finally:
        clear_mesh_axes()
        if created:
            dist.destroy_process_group()
    return {"prefill_s": prefill_s, "prefill_equal": prefill_equal,
            "flash_launches": launches["flash_attention"],
            "decode_equal": decode_equal, "serve_s": serve_s,
            "served_equal": served_equal, "decode_step": step,
            "decode_step_device_rel": rel}


def phase_ssm(device) -> dict:
    """rope on the card, then mamba2-1.3b and zamba2-7b at full depth
    through the port's entry points: prefill, decode against the forward,
    one layer's SSD against the recurrence, ``serve()`` cold and warm, one
    decode step profiled.  Returns each model's numbers and rope's."""
    t0 = time.perf_counter()
    out = {"rope": _rope_on_the_card(device)}
    out.update({arch: _ssm_model(device, arch) for arch in SSM_ARCHS})
    _phase("ssm", t0)
    return out


def _frontend(cfg, batch: int, gen, device):
    """The stub frontend's embeddings, N(0, 1) in the model's dtype:
    ("frames", (B, enc_len, dm)) for whisper, ("patches", (B, n_patches,
    dm)) for the VLM."""
    key, n = (("frames", cfg.enc_len) if cfg.family == "encdec"
              else ("patches", cfg.n_patches))
    return key, torch.randn((batch, n, cfg.d_model), generator=gen,
                            device=device).to(cfg.dtype)


def _cross_kv_share(params, cfg, ctx) -> dict:
    """The cross K/V projections a decode step recomputes from ``ctx``
    (``enc_out`` or the patches; the reference keeps no cross cache): their
    operations and their time alone (CUDA events)."""
    from repro_torch.models import attention as A

    ws = ([lp["cross"] for lp in params["layers"]]
          if cfg.family == "encdec" else list(params["cross_layers"]))

    def run():
        for w in ws:
            A._project(ctx, w["wk"])
            A._project(ctx, w["wv"])

    b, t, dm = ctx.shape
    flops = 2 * b * t * dm * 2 * cfg.n_kv_heads * cfg.hd * len(ws)
    return {"tflop": flops / 1e12, "ms": time_ms(run, 5)}


def _decode_run(params, cfg, toks, extra, device, kernels="auto",
                shard=None):
    """Teacher-forced decode steps over ``toks`` (B, S): the logits (B, S,
    V) in fp32.  ``shard``: a sharded rank's tiles of the decode state
    (``steps.shard_state`` on the mesh), else the whole state."""
    from repro_torch.models import transformer as T

    state = T.init_decode_state(cfg, toks.shape[0], toks.shape[1] + 1,
                                device)
    state = shard(state) if shard else state
    outs = []
    for t in range(toks.shape[1]):
        logits, state = T.decode_step(params, toks[:, t:t + 1], state, cfg,
                                      extra, kernels=kernels)
        outs.append(logits[:, 0].float())
    return torch.stack(outs, dim=1)


def _greedy_serve(params, cfg, first, extra, device, shard=None) -> dict:
    """``make_serve_step`` greedy for ``SERVE["max_new"]`` tokens at the
    batch of ``first`` (B, 1), cache ``SERVE["cache_len"]``: the tokens,
    the wall time and the flash launches of the whole run (counts set to 0
    just before, read just after).  ``shard`` as :func:`_decode_run`'s."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    step = steps.make_serve_step(cfg)
    state = T.init_decode_state(cfg, first.shape[0], SERVE["cache_len"],
                                device)
    state = shard(state) if shard else state
    tok, out = first, []
    torch.cuda.synchronize()
    ops.reset_launches()
    ts = time.perf_counter()
    for _ in range(SERVE["max_new"]):
        tok, state = step(params, {"tokens": tok, **extra}, state)
        out.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    launches = ops.launch_counts()["flash_attention"]
    toks = torch.cat(out, dim=1)
    check(toks.shape == (first.shape[0], SERVE["max_new"])
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: served tokens {tuple(toks.shape)} out of range")
    return {"tokens": toks, "serve_s": wall, "launches": launches}


def _step_profile(params, cfg, extra, batch: int, device,
                  shard=None) -> dict:
    """One decode step at ``batch`` (positions 0..B-1 in a cache of
    ``SERVE["cache_len"]``): wall time against device time, the four
    largest kernels.  ``shard`` as :func:`_decode_run`'s."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    step = steps.make_serve_step(cfg)
    state = T.init_decode_state(cfg, batch, SERVE["cache_len"], device)
    state = state._replace(position=torch.arange(batch, dtype=torch.int32,
                                                 device=device))
    state = shard(state) if shard else state
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)

    def one():
        step(params, {"tokens": tok, **extra}, state)

    walls = []
    for _ in range(6):
        tw = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tw) * 1e3)
    kernels = device_breakdown(one, reps=3)
    return {"decode_step_ms": statistics.median(walls[1:]),
            "decode_step_device_ms": sum(ms * c
                                         for ms, c in kernels.values()),
            "decode_step_kernels": sum(v[1] for v in kernels.values()),
            "top": dict(list(kernels.items())[:4])}


def _xattn_prefill(params, cfg, toks, key, ctx, tag, want_launches) -> tuple:
    """``make_prefill_step`` through the flash kernel (counts set to 0
    just before, read just after), then the same prefill with the plain
    attention: last-token logits within LM_LOGIT_TOL of their scale.
    Returns (the numbers, the kernel's last-token logits)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(cfg, kernels="auto")
    prefill(params, {"tokens": toks[:1, :16], key: ctx[:1]})      # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    tp = time.perf_counter()
    last = prefill(params, {"tokens": toks, key: ctx})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tp
    launches = ops.launch_counts()["flash_attention"]
    check(launches == want_launches, f"{tag}: flash_attention launched "
          f"{launches} times in one prefill, expected {want_launches}")
    tq = time.perf_counter()
    plain = steps.make_prefill_step(cfg, kernels="torch")(
        params, {"tokens": toks, key: ctx})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - tq
    check(last.shape == (toks.shape[0], cfg.vocab)
          and bool(torch.isfinite(last.float()).all()),
          f"{tag}: prefill logits not finite or shaped (B, V)")
    rel = _block_rel(last, plain)
    agree = (last.argmax(-1) == plain.argmax(-1)).float().mean().item()
    b, s = toks.shape
    print(f"{tag}: prefill B={b} S={s} with {key} {tuple(ctx.shape)} in "
          f"{prefill_s:.3f} s ({b * s / prefill_s:.0f} tokens/s), "
          f"flash_attention x {launches}; last-token logits flash vs plain "
          f"attention: max rel diff {rel:.3e} (tolerance {LM_LOGIT_TOL}), "
          f"argmax agreement {agree}; plain prefill {plain_s:.3f} s",
          flush=True)
    check(rel <= LM_LOGIT_TOL, f"{tag}: prefill logits differ from the "
          f"plain attention's ({rel:.3e})")
    return {"prefill_s": prefill_s, "plain_prefill_s": plain_s,
            "flash_launches": launches, "flash_vs_plain_rel": rel,
            "flash_vs_plain_agree": agree}, last


def _xattn_built(cfg, device, tag: str):
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    ti = time.perf_counter()
    params = T.init_params(0, cfg, device)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - ti
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag}: {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_len} "
             f"frames" if cfg.family == "encdec" else
             f" + {cfg.n_layers // cfg.cross_attn_every} cross layers to "
             f"{cfg.n_patches} patches")
          + f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.hd}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters ({n_params * 2 / 1e9:.2f} GB) "
          f"built in {built_s:.3f} s", flush=True)
    return params, {"arch": cfg.name, "params_b": n_params / 1e9,
                    "built_s": built_s}


def _whisper(device) -> dict:
    """whisper-small at full depth: prefill, ``encode``, greedy serve,
    decode against the forward (bf16, and fp32 on an fp32 copy), one
    decode step profiled."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = configs.get_config("whisper-small")
    tag = "xattn whisper-small"
    params, out = _xattn_built(cfg, device, tag)
    b = WHISPER_BATCH
    gen = torch.Generator(device=device).manual_seed(41)
    _, frames = _frontend(cfg, b, gen, device)
    toks = torch.randint(0, cfg.vocab, (b, WHISPER_TEXT), generator=gen,
                         device=device)
    n_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    numbers, last = _xattn_prefill(params, cfg, toks, "frames", frames, tag,
                                   n_prefill)
    out.update(numbers)
    ops.reset_launches()
    te = time.perf_counter()
    enc = T.encode(params, frames, cfg)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - te
    out["encode_launches"] = ops.launch_counts()["flash_attention"]
    check(out["encode_launches"] == cfg.n_enc_layers,
          f"{tag}: flash_attention launched {out['encode_launches']} times "
          f"in encode, expected {cfg.n_enc_layers}")
    served = _greedy_serve(params, cfg, toks[:, :1], {"enc_out": enc},
                           device)
    n = SERVE["max_new"]
    check(served["launches"] == n * cfg.n_layers, f"{tag}: "
          f"flash_attention launched {served['launches']} times in {n} "
          f"decode steps, expected {n * cfg.n_layers}")
    out.update(serve_s=served["serve_s"], serve_launches=served["launches"])
    one = {"last": last, "enc": enc, "served": served["tokens"]}
    print(f"{tag}: encode of {tuple(frames.shape)} in {out['encode_s']:.3f} "
          f"s, flash_attention x {out['encode_launches']}; make_serve_step "
          f"greedy at batch {b}: {n} tokens each in {served['serve_s']:.3f} "
          f"s ({b * n / served['serve_s']:.1f} tokens/s), flash_attention "
          f"x {served['launches']} ({served['launches'] // n} a step)",
          flush=True)

    short = toks[:, :XATTN_DECODE_SEQ]
    for dt in (cfg.dtype, torch.float32):
        dcfg = dataclasses.replace(cfg, dtype=dt)
        dparams = params if dt == cfg.dtype else T.init_params(0, dcfg,
                                                               device)
        f = frames.to(dt)
        full, _ = T.forward(dparams, short, dcfg, {"frames": f})
        dec = _decode_run(dparams, dcfg, short,
                          {"enc_out": T.encode(dparams, f, dcfg)}, device)
        rel = _block_rel(dec, full)
        agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
        key = "fp32" if dt == torch.float32 else "bf16"
        print(f"{tag}: decode vs forward on S={XATTN_DECODE_SEQ} in {dt}: "
              f"argmax agreement {agree:.4f} (held > 0.9), max rel diff "
              f"{rel:.3e}" + (f" (tolerance {XATTN_FP32_TOL})"
                               if key == "fp32" else ""), flush=True)
        check(agree > 0.9 and (key == "bf16" or rel <= XATTN_FP32_TOL),
              f"{tag}: {key} decode differs from the forward (agreement "
              f"{agree}, max rel diff {rel:.3e})")
        out.update({f"decode_vs_forward_rel_{key}": rel,
                    f"decode_argmax_agree_{key}": agree})
        if dt == cfg.dtype:
            one["decode"] = dec
        del dparams, full, dec
        torch.cuda.empty_cache()

    out["cross_kv"] = _cross_kv_share(params, cfg, enc)
    out.update(_step_profile(params, cfg, {"enc_out": enc}, b, device))
    out["mesh_1x1"] = _xattn_sharded(
        device, cfg, params, {"tokens": toks, "frames": frames}, short,
        {"enc_out": enc}, one, out, tag, n_prefill, cfg.n_layers)
    return _xattn_done(tag, out, params, device)


def _xattn_sharded(device, cfg, params, batch, short, extra, one: dict,
                   one_numbers: dict, tag: str, n_prefill: int,
                   n_step: int) -> dict:
    """The same model through the sharded path (ROADMAP §1 row 22) on a 1×1
    ("data", "model") mesh over a one-rank NCCL group: the rank's tiles
    (``steps.shard_params``; on one rank a tile is the weight itself, so
    the weights are held once), the mesh declared, then
    ``make_prefill_step`` on the rank's rows of ``batch`` (tokens and
    frames or patches: each attention through ``_attn_apply_tp`` and the
    flash kernel, ``n_prefill`` launches counted by the wrapper, the gelu
    or SwiGLU MLP through ``mlp_apply``'s split branch), whisper's
    ``encode``, the teacher-forced decode on ``short`` (the state from
    ``steps.shard_state``, ``extra``'s ``enc_out`` or patches
    batch-sharded) and the greedy ``make_serve_step`` (``n_step`` launches
    a step), each held bit for bit against the one-device path's (``one``:
    its last-token logits, ``enc_out``, decode logits and served tokens),
    and one decode step profiled, its device time held within
    ``MESH_STEP_TOL`` of one device's (``one_numbers``)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                         make_host_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes

    mtag = f"{tag} mesh 1x1"
    t0 = time.perf_counter()
    created = init_distributed(device)
    try:
        mesh = make_host_mesh(1, device)
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        psh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                    fsdp=False)
        rp = steps.shard_params(params, psh, mesh)
        same = all(a.data_ptr() == b.data_ptr() for a, b in
                   zip(rp.parameters(), params.parameters()))
        check(same, f"{mtag}: a one-rank tile is a copy, not the weight")
        tp = T._tp_layout(rp, cfg)

        def local(b: dict) -> dict:
            return steps.shard_batch(b, steps.batch_shardings(mesh, b), mesh)

        def shard(state):
            return steps.shard_state(state, steps.cache_shardings(
                mesh, cfg, state.caches), mesh)

        prefill = steps.make_prefill_step(cfg, kernels="auto")
        rows = local(batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        tp_s = time.perf_counter()
        last = prefill(rp, rows)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - tp_s
        launches = ops.launch_counts()["flash_attention"]
        prefill_equal = bool(torch.equal(last, one["last"]))
        del last
        res = {"prefill_s": prefill_s, "prefill_equal": prefill_equal,
               "flash_launches": launches}
        equal = [prefill_equal]
        enc_note = ""
        if cfg.family == "encdec":
            ops.reset_launches()
            enc = T.encode(rp, rows["frames"], cfg)
            res["encode_launches"] = ops.launch_counts()["flash_attention"]
            res["encode_equal"] = bool(torch.equal(enc, one["enc"]))
            equal.append(res["encode_equal"])
            check(res["encode_launches"] == cfg.n_enc_layers,
                  f"{mtag}: flash_attention launched "
                  f"{res['encode_launches']} times in encode")
            enc_note = (f"; encode equal bit for bit: {res['encode_equal']} "
                        f"(flash_attention x {res['encode_launches']})")
            del enc
        print(f"{mtag}: layout heads={tp.heads} kv_heads={tp.kv_heads} "
              f"ffn={tp.ffn}; prefill of {tuple(batch['tokens'].shape)} in "
              f"{prefill_s:.3f} s, last-token logits equal to the one-device "
              f"prefill's bit for bit: {prefill_equal}, flash_attention x "
              f"{launches}{enc_note}", flush=True)
        check(prefill_equal, f"{mtag}: the sharded prefill's logits differ "
              "from the one-device prefill's")
        check(launches == n_prefill, f"{mtag}: flash_attention launched "
              f"{launches} times in the sharded prefill, expected "
              f"{n_prefill}")
        ext = local(extra)
        dec = _decode_run(rp, cfg, short, ext, device, shard=shard)
        res["decode_equal"] = bool(torch.equal(dec, one["decode"]))
        equal.append(res["decode_equal"])
        del dec
        torch.cuda.empty_cache()
        served = _greedy_serve(rp, cfg, short[:, :1], ext, device,
                               shard=shard)
        res["served_equal"] = bool(torch.equal(served["tokens"],
                                               one["served"]))
        equal.append(res["served_equal"])
        n = SERVE["max_new"]
        res.update(serve_s=served["serve_s"],
                   serve_launches=served["launches"])
        step = _step_profile(rp, cfg, ext, short.shape[0], device,
                             shard=shard)
        step.pop("top")
        res["decode_step"] = step
        rel = (step["decode_step_device_ms"]
               / one_numbers["decode_step_device_ms"] - 1)
        res["decode_step_device_rel"] = rel
        print(f"{mtag}: decode of S={short.shape[1]} equal to the "
              f"one-device decode's logits bit for bit: "
              f"{res['decode_equal']}; make_serve_step greedy, {n} tokens at "
              f"batch {short.shape[0]} in {served['serve_s']:.3f} s (one "
              f"device: {one_numbers['serve_s']:.3f} s), its tokens equal to "
              f"the one-device tokens: {res['served_equal']}, "
              f"flash_attention x {served['launches']}; one decode step: "
              f"{step['decode_step_ms']:.3f} ms wall, "
              f"{step['decode_step_device_ms']:.3f} ms on the device in "
              f"{step['decode_step_kernels']} kernels (one device: "
              f"{one_numbers['decode_step_ms']:.3f} ms wall, "
              f"{one_numbers['decode_step_device_ms']:.3f} ms in "
              f"{one_numbers['decode_step_kernels']}; device {rel:+.2%}, "
              f"tolerance {MESH_STEP_TOL:.0%}); "
              f"{time.perf_counter() - t0:.1f} s [{nvidia_smi()}]",
              flush=True)
        check(all(equal), f"{mtag}: the sharded path differs from the "
              f"one-device path: {json.dumps(res)}")
        check(served["launches"] == n * n_step, f"{mtag}: flash_attention "
              f"launched {served['launches']} times in {n} decode steps, "
              f"expected {n * n_step}")
        check(abs(rel) <= MESH_STEP_TOL, f"{mtag}: the decode step's device "
              f"time {step['decode_step_device_ms']:.3f} ms differs from one "
              f"device's by {rel:+.2%}")
        del rp
    finally:
        clear_mesh_axes()
        if created:
            dist.destroy_process_group()
    return res


def _xattn_done(tag: str, out: dict, params, device) -> dict:
    """Prints the decode step's numbers and the cross K/V share, frees the
    weights."""
    top = out.pop("top")
    kv = out["cross_kv"]
    kv["share_of_step"] = kv["ms"] / out["decode_step_device_ms"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    step_ms = out["decode_step_ms"]
    print(f"{tag}: one decode step at batch {SERVE['batch']}: {step_ms:.3f} "
          f"ms wall, {out['decode_step_device_ms']:.3f} ms on the device in "
          f"{out['decode_step_kernels']} kernels (idle share "
          f"{1 - out['decode_step_device_ms'] / step_ms:.3f}); the cross K/V "
          f"projections it recomputes: {kv['tflop']:.3f} TFLOP, "
          f"{kv['ms']:.3f} ms alone ({kv['share_of_step']:.1%} of the "
          f"step's device time); largest {json.dumps(top)}; peak memory "
          f"{out['peak_gb']:.3f} GB", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def _vlm(device) -> dict:
    """llama-3.2-vision-11b at full depth: prefill, greedy serve, the
    kernel's decode against the plain one (the forward printed beside
    it: the reference's decode order differs from its forward), one
    decode step profiled."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = configs.get_config("llama-3.2-vision-11b")
    tag = "xattn llama-3.2-vision-11b"
    n_cross = cfg.n_layers // cfg.cross_attn_every
    params, out = _xattn_built(cfg, device, tag)
    gen = torch.Generator(device=device).manual_seed(43)
    _, patches = _frontend(cfg, SERVE["batch"], gen, device)
    toks = torch.randint(0, cfg.vocab, (SERVE["batch"], LM_SEQ),
                         generator=gen, device=device)
    numbers, last = _xattn_prefill(params, cfg, toks[:LM_BATCH], "patches",
                                   patches[:LM_BATCH], tag,
                                   cfg.n_layers + n_cross)
    out.update(numbers)
    served = _greedy_serve(params, cfg, toks[:, :1], {"patches": patches},
                           device)
    n = SERVE["max_new"]
    check(served["launches"] == n * n_cross, f"{tag}: flash_attention "
          f"launched {served['launches']} times in {n} decode steps, "
          f"expected {n * n_cross}")
    out.update(serve_s=served["serve_s"], serve_launches=served["launches"])
    print(f"{tag}: make_serve_step greedy at batch {SERVE['batch']}: {n} "
          f"tokens each in {served['serve_s']:.3f} s "
          f"({SERVE['batch'] * n / served['serve_s']:.1f} tokens/s), "
          f"flash_attention x {served['launches']} "
          f"({served['launches'] // n} a step)", flush=True)

    short = toks[:, :XATTN_DECODE_SEQ]
    extra = {"patches": patches}
    dec = _decode_run(params, cfg, short, extra, device)
    plain = _decode_run(params, cfg, short, extra, device, kernels="torch")
    full, _ = T.forward(params, short, cfg, extra)
    rel = _block_rel(dec, plain)
    agree = (dec.argmax(-1) == plain.argmax(-1)).float().mean().item()
    fwd_rel = _block_rel(dec, full)
    fwd_agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"{tag}: decode through the kernel vs the plain attention on "
          f"S={XATTN_DECODE_SEQ}: max rel diff {rel:.3e} (tolerance "
          f"{LM_LOGIT_TOL}), argmax agreement {agree:.4f}; vs the forward "
          f"(printed, not held: the decode runs the cross layers after "
          f"all dense layers, as the reference's): max rel diff "
          f"{fwd_rel:.3e}, argmax agreement {fwd_agree:.4f}", flush=True)
    check(rel <= LM_LOGIT_TOL and bool(torch.isfinite(dec).all()),
          f"{tag}: the kernel's decode differs from the plain one "
          f"({rel:.3e})")
    out.update(decode_kernel_vs_plain_rel=rel,
               decode_kernel_vs_plain_agree=agree,
               decode_vs_forward_rel=fwd_rel,
               decode_vs_forward_agree=fwd_agree)
    one = {"last": last, "decode": dec, "served": served["tokens"]}
    del plain, full
    torch.cuda.empty_cache()
    out["cross_kv"] = _cross_kv_share(params, cfg, patches)
    out.update(_step_profile(params, cfg, extra, SERVE["batch"], device))
    out["mesh_1x1"] = _xattn_sharded(
        device, cfg, params, {"tokens": toks[:LM_BATCH],
                              "patches": patches[:LM_BATCH]},
        short, extra, one, out, tag, cfg.n_layers + n_cross, n_cross)
    del one, dec
    return _xattn_done(tag, out, params, device)


def phase_xattn(device) -> dict:
    """whisper-small and llama-3.2-vision-11b at full depth through the
    port's entry points, then kernel 7 alone at each shape of that path
    (``XATTN_CASES``).  Returns the models' numbers and the kernel's rows."""
    t0 = time.perf_counter()
    out = {"whisper-small": _whisper(device),
           "llama-3.2-vision-11b": _vlm(device)}
    gen = torch.Generator(device=device).manual_seed(47)
    rows = []
    for b, s, t, h, kvh, dh, causal, where in XATTN_CASES:
        name = (f"flash {where}: B={b} S={s} T={t} H={h} KVH={kvh} Dh={dh} "
                f"{'causal' if causal else 'full'}")
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16) for shape in ((b, s, h, dh), (b, t, kvh, dh),
                                          (b, t, kvh, dh)))
        rows.append(_flash_row(name, q, k, v, causal, {
            "where": where, "b": b, "s": s, "t": t, "h": h, "kvh": kvh,
            "dh": dh, "dtype": "torch.bfloat16", "causal": causal}))
        del q, k, v
        torch.cuda.empty_cache()
    out["rows"] = rows
    _phase("xattn", t0)
    return out


def _kernel_durations(prof) -> list:
    """(name, µs) of each kernel a torch.profiler window lists, from its
    raw kineto events: a train step launches 2·10⁴–4·10⁴ kernels, and
    ``prof.events()`` would build its event tree over them for seconds."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.duration_ns() / 1e3) for e in raw
                if e.device_type() == cuda]
    except AttributeError:                  # a torch without the raw events
        return [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
                if ev.device_type == cuda]


def _step_timed(step, params, state, batch, device, tokens: int):
    """One call of a train step under torch.profiler: wall time (synced),
    the device time of the kernels it lists (None for a window it left
    out), peak memory, tokens/s, loss and gnorm."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    tp = time.perf_counter()
    kernels = _kernel_durations(prof)
    parse_s = time.perf_counter() - tp
    device_s = (sum(us for _, us in kernels) / 1e6 if kernels else None)
    by_name: dict = {}
    for raw, us in kernels:
        name = kernel_name(raw)[:60]
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rec = {"wall_s": wall, "device_s": device_s, "kernels": len(kernels),
           "window_s": time.perf_counter() - tw, "parse_s": parse_s,
           "top_ms": {k: v / 1e3 for k, v in top},
           "idle_share": None if device_s is None else 1 - device_s / wall,
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "tokens_per_s": tokens / wall, "loss": float(m["loss"]),
           "aux": float(m["aux"]), "gnorm": float(m["gnorm"])}
    return params, state, rec


def _print_step(tag: str, i: int, rec: dict, smi: str) -> None:
    dev = ("not measured (the profiler listed no kernel)"
           if rec["device_s"] is None else
           f"{rec['device_s']:.3f} s on the device in {rec['kernels']} "
           f"kernels (idle share {rec['idle_share']:.3f})")
    print(f"{tag} step {i}: {rec['wall_s']:.3f} s wall, {dev}, peak "
          f"{rec['peak_gb']:.3f} GB, {rec['tokens_per_s']:.0f} tokens/s, "
          f"loss {rec['loss']:.4f}, gnorm {rec['gnorm']:.4f} (profiler "
          f"window {rec['window_s']:.1f} s) [{smi}]", flush=True)


def _train_steps(tag, cfg, params, opt, state, batch, steps_, device,
                 smi) -> tuple:
    """The steps numbered ``steps_`` of ``make_train_step`` on one batch
    from ``state`` (a fresh one if None), each timed; losses and gnorms
    finite."""
    from repro_torch.launch import steps

    step = steps.make_train_step(cfg, opt)
    state = opt.init(params) if state is None else state
    recs = []
    for i in steps_:
        params, state, rec = _step_timed(step, params, state, batch, device,
                                         batch["tokens"].numel())
        _print_step(tag, i, rec, smi)
        check(np.isfinite(rec["loss"]) and np.isfinite(rec["gnorm"]),
              f"{tag}: step {i} loss or gnorm not finite")
        recs.append(rec)
    return params, state, recs


def _retake_device(tag, cfg, params, opt, state, batch, recs, device, smi):
    """A step whose profiler window listed nothing is timed again, up to
    five more steps, the first window that lists kernels kept."""
    if all(r["device_s"] is not None for r in recs):
        return None
    from repro_torch.launch import steps

    step = steps.make_train_step(cfg, opt)
    for i in range(5):
        params, state, rec = _step_timed(step, params, state, batch, device,
                                         batch["tokens"].numel())
        _print_step(f"{tag} retake", i + 1, rec, smi)
        if rec["device_s"] is not None:
            return rec
    return None


def _split_step(cfg, params, opt, state, batch, tag, smi) -> dict:
    """One more step in its two halves, each synced: the forward and
    backward (``steps.loss_and_grads``), then the optimizer's update."""
    from repro_torch.launch import steps

    torch.cuda.synchronize()
    tw = time.perf_counter()
    _, _, grads = steps.loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    fwd_bwd = time.perf_counter() - tw
    tw = time.perf_counter()
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    update = time.perf_counter() - tw
    print(f"{tag}: one step split: forward + backward {fwd_bwd:.3f} s, "
          f"{opt.name} update {update:.3f} s [{smi}]", flush=True)
    return {"fwd_bwd_s": fwd_bwd, "update_s": update}


def _granite_train(device, smi: str) -> dict:
    """(a) granite-3-2b at full width and depth: adamw steps, then one
    adafactor step on the same weights."""
    import gc

    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers, schedule

    cfg = configs.get_config(TRAIN_ARCH)
    tag = f"train {cfg.name}"
    torch.cuda.empty_cache()
    params = T.init_params(0, cfg, device)
    n_params = sum(p.numel() for p in params.parameters())
    first = params.layers[0].mlp.gate[:64, :64].clone()
    opt = optimizers.adamw(schedule.cosine_schedule(
        3e-4, warmup=1, total=TRAIN_STEPS))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "seq": TRAIN_SEQ,
           "params_b": n_params / 1e9, "remat_policy": cfg.remat_policy}
    for b in (TRAIN_BATCH, TRAIN_BATCH_MIN):
        batch = synthetic_token_stream(0, cfg.vocab, b, TRAIN_SEQ, device)(0)
        oom, state, recs = False, None, None
        try:
            params, state, recs = _train_steps(tag + f" B={b}", cfg, params,
                                               opt, None, batch, [1], device,
                                               smi)
        except torch.cuda.OutOfMemoryError:
            oom = True
        if not oom and recs[0]["peak_gb"] <= TRAIN_PEAK_GB:
            break
        check(b > TRAIN_BATCH_MIN, f"{tag}: B={b} does not fit")
        print(f"{tag}: B={b} " + ("ran out of memory" if oom else
              f"peaked at {recs[0]['peak_gb']:.3f} GB") + f"; B={b - 1}",
              flush=True)
        out[f"b{b}_first_step"] = "out of memory" if oom else recs[0]
        state = recs = None
        gc.collect()
        torch.cuda.empty_cache()
    out["batch"] = b
    params, state, more = _train_steps(
        tag + f" B={b}", cfg, params, opt, state, batch,
        range(2, TRAIN_STEPS + 1), device, smi)
    step_recs = recs + more
    out["retake"] = _retake_device(tag, cfg, params, opt, state, batch,
                                   step_recs, device, smi)
    out["adamw_steps"] = step_recs
    out["split"] = _split_step(cfg, params, opt, state, batch, tag, smi)
    moved = float((params.layers[0].mlp.gate[:64, :64].float()
                   - first.float()).abs().max())
    check(moved > 0, f"{tag}: the weights did not move")
    out["moved"] = moved
    del state
    gc.collect()
    torch.cuda.empty_cache()
    fact = optimizers.adafactor(1e-2)
    params, _, recs = _train_steps(tag + f" adafactor B={b}", cfg, params,
                                   fact, None, batch, [1], device, smi)
    out["adafactor_step"] = recs[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_train(device, smi: str, b: int) -> dict:
    """(a') granite-3-2b at full width and depth, one adamw step through
    the sharded train step on a 1×1 mesh over a one-rank NCCL group (the
    weights and the state from ``shard_params``/``shard_opt_state``, the
    mesh declared) against the one-device step on the same seeded weights
    and batch: loss, gnorm and every updated weight, both steps timed.
    The embedding's backward sums with atomics on the card, so the two
    runs may round a gradient apart: each updated leaf is held to a bf16
    rounding of its largest |w|, and the leaves equal bit for bit are
    counted."""
    import gc

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                         make_host_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
    from repro_torch.optim import optimizers

    cfg = configs.get_config(TRAIN_ARCH)
    tag = f"train {cfg.name} mesh"
    torch.cuda.empty_cache()
    batch = synthetic_token_stream(0, cfg.vocab, b, TRAIN_SEQ, device)(0)
    opt = optimizers.adamw(3e-4)
    step = steps.make_train_step(cfg, opt)
    params = T.init_params(0, cfg, device)
    seeded = {p: [t.to("cpu", copy=True) for t in leaf.tensors]
              for p, leaf in params.ref_leaves().items()}
    params, state, one = _step_timed(step, params, opt.init(params), batch,
                                     device, batch["tokens"].numel())
    _print_step(tag + f" one-device B={b}", 1, one, smi)
    after = {p: [t.to("cpu", copy=True) for t in leaf.tensors]
             for p, leaf in params.ref_leaves().items()}
    del state
    with torch.no_grad():
        for p, leaf in params.ref_leaves().items():
            for t, h in zip(leaf.tensors, seeded[p]):
                t.copy_(h)
    del seeded
    gc.collect()
    torch.cuda.empty_cache()
    created = init_distributed(device)
    try:
        mesh = make_host_mesh(1, device)
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        psh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                    fsdp=False)
        tiles = steps.shard_params(params, psh, mesh)
        del params
        whole = opt.init(tiles)
        osh = steps.opt_state_shardings(mesh, whole, psh)
        state = steps.shard_opt_state(whole, osh, mesh)
        del whole
        local = steps.shard_batch(batch, steps.batch_shardings(mesh, batch),
                                  mesh)
        gc.collect()
        torch.cuda.empty_cache()
        tiles, state, rec = _step_timed(step, tiles, state, local, device,
                                        batch["tokens"].numel())
        _print_step(tag + f" 1x1 B={b}", 1, rec, smi)
    finally:
        clear_mesh_axes()
        if created:
            dist.destroy_process_group()
    del state
    worst, equal = 0.0, 0
    with torch.no_grad():
        for p, leaf in tiles.ref_leaves().items():
            d = scale = 0.0
            for t, h in zip(leaf.tensors, after[p]):
                h = h.to(device)
                d = max(d, float((t.float() - h.float()).abs().max()))
                scale = max(scale, float(h.float().abs().max()))
            equal += d == 0
            worst = max(worst, d / (scale or 1.0))
    rel = {k: abs(rec[k] / one[k] - 1) for k in ("loss", "gnorm")}
    print(f"{tag}: the 1x1 mesh step against the one-device step: loss "
          f"{rec['loss']:.6f} vs {one['loss']:.6f} (rel {rel['loss']:.2e}),"
          f" gnorm {rec['gnorm']:.6f} vs {one['gnorm']:.6f} (rel "
          f"{rel['gnorm']:.2e}); updated weights: {equal} of {len(after)} "
          f"leaves equal, the largest |Δ| {worst:.2e} of its leaf's "
          f"largest |w|; wall {rec['wall_s']:.3f} vs {one['wall_s']:.3f} s, "
          f"peak {rec['peak_gb']:.3f} vs {one['peak_gb']:.3f} GB [{smi}]",
          flush=True)
    check(rel["loss"] <= 1e-6 and rel["gnorm"] <= 1e-5
          and worst <= 2.0 ** -7,
          f"{tag}: the 1x1 mesh step differs from the one-device step")
    del tiles, after
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": b, "one_device": one, "mesh_1x1": rec,
            "rel": rel, "leaves_equal": equal, "worst_weight": worst}


def _fingerprint(params) -> list:
    """Each weight leaf's fp64 sum (two seeded inits are compared by it)."""
    return [float(sum(t.double().sum() for t in leaf.tensors))
            for leaf in params.ref_leaves().values()]


def _moe_train(device, smi: str) -> dict:
    """(e) deepseek-v3 at full width and ``TRAIN_MOE``'s depth (one layer:
    MLA, 256 + 1 experts; 26.7 GB of bf16 weights), one adafactor step
    through the sharded train step on a 1×1 mesh over a one-rank NCCL group
    (the rank's tiles the weights themselves; ROADMAP §1 row 22) against
    the one-device step, bit for bit (:func:`_mesh_vs_one`).  The
    peak is reckoned first (the weights, their gradients of the same
    bytes, adafactor's state and its largest fp32 temporaries: an expert
    stack's are a piece's, at most ``optimizers.PIECE_BYTES``, so the
    (dm, vocab) embedding's are the largest); above ``TRAIN_PEAK_GB`` the
    part is left out and says why."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.optim import optimizers

    arch, depth, b, s = TRAIN_MOE
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=depth)
    tag = f"train {cfg.name} x{depth} mesh"
    total, _ = cfg.param_count()
    weights_gb = total * 2 / 1e9
    state_gb = (depth * 3 * cfg.n_experts * (cfg.d_model + cfg.d_ff) * 4
                / 1e9)
    # adafactor's fp32 temporaries: 4 copies of a row at once (the
    # update's u, the weight, lr·u and the new weight), an expert stack's
    # a piece of at most PIECE_BYTES, the (dm, vocab) embedding's whole
    temps_gb = 4 * max(optimizers.PIECE_BYTES,
                       4 * cfg.d_model * cfg.vocab) / 1e9
    reckon = 2 * weights_gb + state_gb + temps_gb
    print(f"{tag}: peak reckoned {reckon:.1f} GB (weights {weights_gb:.1f},"
          f" gradients {weights_gb:.1f}, the experts' adafactor state "
          f"{state_gb:.2f}, adafactor's largest fp32 temporaries "
          f"{temps_gb:.2f}: the embedding's; activations at B={b} S={s} "
          f"besides) [{smi}]", flush=True)
    if reckon > TRAIN_PEAK_GB:
        print(f"{tag}: left out, above {TRAIN_PEAK_GB} GB", flush=True)
        return {"skipped": f"peak reckoned {reckon:.1f} GB"}
    # the card's index_add (the MoE dispatch's index_select backward) and
    # embedding backward add with atomics, so two runs of the same step
    # differ (gnorm 36.0678 / 36.0680 in two runs on an H100): both run
    # with PyTorch's deterministic algorithms (:func:`_mesh_vs_one`)
    out = _mesh_vs_one(device, smi, cfg, tag, b, s, optimizers.adafactor())
    out["reckoned_gb"] = reckon
    return out


def _mesh_vs_one(device, smi, cfg, tag, b, s, opt) -> dict:
    """One ``opt`` step of ``cfg`` (seeded weights, one
    ``synthetic_token_stream`` batch of B = ``b``, S = ``s``, with the stub
    frontend's frames or patches for encdec and the VLM) on one device
    and through the sharded train step on a 1×1 mesh over a one-rank NCCL
    group, the weights made twice from the seed (their leaves' sums
    compared), both with PyTorch's deterministic algorithms (the card's
    embedding backward adds with atomics): loss, aux, gnorm and every
    updated weight (the one-device step's kept on the host, an expert
    stack compared a piece at a time) held bit for bit."""
    import gc

    import torch.distributed as dist

    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                         make_host_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
    from repro_torch.optim.optimizers import expert_pieces

    from repro_torch.launch.train import stub_inputs

    torch.cuda.empty_cache()
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        batch = {**synthetic_token_stream(0, cfg.vocab, b, s, device)(0),
                 **stub_inputs(cfg, b, 0, device)}
        step = steps.make_train_step(cfg, opt)
        params = T.init_params(0, cfg, device)
        seeded = _fingerprint(params)
        before_gb = torch.cuda.memory_allocated(device) / 1e9
        params, state, one = _step_timed(step, params, opt.init(params),
                                         batch, device, b * s)
        _print_step(tag + f" one-device B={b} S={s}", 1, one, smi)
        after = {p: [t.to("cpu", copy=True) for t in leaf.tensors]
                 for p, leaf in params.ref_leaves().items()}
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        params = T.init_params(0, cfg, device)
        check(_fingerprint(params) == seeded,
              f"{tag}: the seeded weights differ between two inits")
        created = init_distributed(device)
        try:
            mesh = make_host_mesh(1, device)
            set_mesh_axes(data_axis_names(mesh), mesh=mesh)
            psh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                        fsdp=False)
            tiles = steps.shard_params(params, psh, mesh)
            del params
            whole = opt.init(tiles)
            osh = steps.opt_state_shardings(mesh, whole, psh)
            state = steps.shard_opt_state(whole, osh, mesh)
            del whole
            local = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            tiles, state, rec = _step_timed(step, tiles, state, local,
                                            device, b * s)
            _print_step(tag + f" 1x1 B={b} S={s}", 1, rec, smi)
        finally:
            clear_mesh_axes()
            if created:
                dist.destroy_process_group()
        del state
        equal = 0
        with torch.no_grad():             # an expert stack a piece at a time
            for p, leaf in tiles.ref_leaves().items():
                equal += all(torch.equal(t[part], h[part].to(device))
                             for t, h in zip(leaf.tensors, after[p])
                             for part in expert_pieces(t))
        same = {k: rec[k] == one[k] for k in ("loss", "aux", "gnorm")}
        print(f"{tag}: the 1x1 mesh step against the one-device step: loss "
              f"{rec['loss']:.6f} vs {one['loss']:.6f}, gnorm "
              f"{rec['gnorm']:.6f} vs {one['gnorm']:.6f} (equal: "
              f"{json.dumps(same)}); updated weights: {equal} of "
              f"{len(after)} leaves equal bit for bit; wall "
              f"{rec['wall_s']:.3f} vs {one['wall_s']:.3f} s, peak "
              f"{rec['peak_gb']:.3f} vs {one['peak_gb']:.3f} GB (allocated "
              f"before the step, the weights among it: {before_gb:.3f}) "
              f"[{smi}]", flush=True)
        check(all(same.values()) and equal == len(after),
              f"{tag}: the 1x1 mesh step differs from the one-device step")
        del tiles, after
        gc.collect()
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "depth": cfg.n_layers, "batch": b,
                "seq": s, "allocated_before_gb": before_gb,
                "one_device": one, "mesh_1x1": rec, "leaves_equal": equal}
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])


def _whisper_mesh_train(device, smi: str) -> dict:
    """(h) whisper-small at full depth, B = 8 requests of 1500 frames at S =
    448, one adamw step through the sharded train step on a 1×1 mesh
    against the one-device step, bit for bit (:func:`_mesh_vs_one`)."""
    from repro_torch import configs
    from repro_torch.optim import optimizers

    arch, b, s = TRAIN_WHISPER_MESH
    cfg = configs.get_config(arch)
    return _mesh_vs_one(device, smi, cfg, f"train {cfg.name} mesh", b, s,
                        optimizers.adamw(3e-4))


def _vlm_reckon(cfg, b: int, s: int) -> float:
    """A VLM train step's peak (GB), reckoned: the bf16 weights and their
    gradients and adamw's fp32 m and v (12 bytes a parameter), adamw's fp32
    temporaries of the largest row (six copies of the (V, dm) embedding's,
    as :func:`_hybrid_train` reckons them), the products ``"dots"`` saves a
    dense layer (q, k, v, wo's, gate's, up's and down's outputs) and the
    fp32 logits with their gradient (twice each)."""
    n = cfg.param_count()[0]
    temps = 6 * 4 * cfg.vocab * cfg.d_model
    width = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        + 2 * cfg.d_ff + cfg.d_model
    acts = cfg.n_layers * b * s * width * 2
    logits = 4 * 4 * b * s * cfg.vocab
    return (12 * n + temps + acts + logits) / 1e9


def _vlm_mesh_train(device, smi: str) -> dict:
    """(i) llama-3.2-vision-11b at full width cut to ``TRAIN_VLM``'s depth
    (10 of 40 layers: 2 cross layers, cross_attn_every 5), B = 1, S =
    4096, 1600 patches: one adamw step through the sharded train step on a
    1×1 mesh against the one-device step, bit for bit
    (:func:`_mesh_vs_one`), its peak reckoned first
    (:func:`_vlm_reckon`) and the depth cut by 5 layers while it is above
    ``TRAIN_PEAK_GB``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.optim import optimizers

    arch, depth, b, s = TRAIN_VLM
    full = configs.get_config(arch)
    every = full.cross_attn_every
    while depth > every and _vlm_reckon(dataclasses.replace(
            full, n_layers=depth), b, s) > TRAIN_PEAK_GB:
        depth -= every
    cfg = dataclasses.replace(full, n_layers=depth)
    tag = f"train {cfg.name} x{depth} mesh"
    reckoned = _vlm_reckon(cfg, b, s)
    print(f"{tag}: depth {depth} of {full.n_layers} ({depth // every} "
          f"cross layers), {cfg.param_count()[0] / 1e9:.3f} B parameters, "
          f"peak reckoned {reckoned:.1f} GB (the whole model would reckon "
          f"{_vlm_reckon(full, b, s):.1f}) [{smi}]", flush=True)
    out = _mesh_vs_one(device, smi, cfg, tag, b, s, optimizers.adamw(3e-4))
    out["reckoned_gb"] = reckoned
    return out


def _ssm_mesh_train(device, smi: str) -> dict:
    """(f) mamba2-1.3b at full depth, one adamw step through the sharded
    train step on a 1×1 mesh against the one-device step, bit for bit
    (:func:`_mesh_vs_one`)."""
    from repro_torch import configs
    from repro_torch.optim import optimizers

    arch, b, s = TRAIN_SSM_MESH
    cfg = configs.get_config(arch)
    return _mesh_vs_one(device, smi, cfg, f"train {cfg.name} mesh", b, s,
                        optimizers.adamw(3e-4))


def _hybrid_train(device, smi: str) -> dict:
    """(g) zamba2-7b at full width, one adamw step through the sharded train
    step on a 1×1 mesh against the one-device step, bit for bit
    (:func:`_mesh_vs_one`), at the deepest multiple of ``attn_every`` (so
    that the shared block runs, once every 6 layers) whose peak is
    reckoned under ``TRAIN_HYBRID_GB``: the bf16 weights and their
    gradients, adamw's fp32 m and v (12 bytes a parameter), adamw's fp32
    temporaries of the largest row (six copies: the gradient, m's and v's
    new values and the update's terms; the (V, dm) embedding's) and the
    activations at B = 1, S = 256 (the layer's saved products: a few MB a
    layer)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.optim import optimizers

    arch, b, s = TRAIN_HYBRID
    full = configs.get_config(arch)

    def reckon(depth: int) -> float:
        cfg = dataclasses.replace(full, n_layers=depth)
        n = cfg.param_count()[0]
        scfg = cfg.ssm_cfg()
        width = 2 * scfg.d_inner + 2 * scfg.d_state + scfg.heads
        temps = 6 * 4 * cfg.vocab * cfg.d_model
        acts = depth * b * s * (4 * cfg.d_model + 2 * width) * 2
        return (12 * n + temps + acts) / 1e9

    depth = full.n_layers - full.n_layers % full.attn_every
    while depth > full.attn_every and reckon(depth) > TRAIN_HYBRID_GB:
        depth -= full.attn_every
    cfg = dataclasses.replace(full, n_layers=depth)
    tag = f"train {cfg.name} x{depth} mesh"
    n_attn = depth // cfg.attn_every
    print(f"{tag}: depth {depth} of {full.n_layers} ({n_attn} "
          f"applications of the shared block), peak "
          f"reckoned {reckon(depth):.1f} GB (12 bytes a parameter for "
          f"{cfg.param_count()[0] / 1e9:.3f} B; {depth + cfg.attn_every} "
          f"layers would reckon {reckon(depth + cfg.attn_every):.1f}, above "
          f"{TRAIN_HYBRID_GB} GB) [{smi}]", flush=True)
    out = _mesh_vs_one(device, smi, cfg, tag, b, s, optimizers.adamw(3e-4))
    out["reckoned_gb"] = reckon(depth)
    return out


def _grads_of(step_opt):
    """An optimizer that keeps the gradients it is handed, then updates."""
    from repro_torch.optim.optimizers import Optimizer

    kept = {}

    def update(grads, state, params):
        kept.update(grads)
        return step_opt.update(grads, state, params)
    return Optimizer(step_opt.init, update, step_opt.name), kept


def _fp32_check(device, smi: str) -> dict:
    """(b) granite-3-2b at full width, cut depth, fp32: one train step on
    the card and the same step on the CPU from the same weights and batch;
    loss and gnorm within rtol 1e-5, each leaf's gradient within
    ``TRAIN_GRAD_TOL`` of its largest |g|."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers

    depth, b, s = TRAIN_CHECK
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_layers=depth,
                              dtype=torch.float32)
    tag = f"train {cfg.name} fp32 check"
    cpu = T.init_params(0, cfg, "cpu")
    card = copy.deepcopy(cpu).to(device)
    batch = synthetic_token_stream(0, cfg.vocab, b, s)(0)
    out, grads = {}, {}
    for where, params in (("card", card), ("cpu", cpu)):
        opt, kept = _grads_of(optimizers.adamw(1e-3))
        tw = time.perf_counter()
        _, _, m = steps.make_train_step(cfg, opt)(
            params, opt.init(params),
            {k: v.to(params.device) for k, v in batch.items()})
        if where == "card":
            torch.cuda.synchronize()
        out[f"{where}_s"] = time.perf_counter() - tw
        out[where] = {k: float(v) for k, v in m.items()}
        grads[where] = {p: [g.cpu() for g in rows] for p, rows in kept.items()}
    worst, at = -1.0, None
    for path, rows in grads["cpu"].items():
        want = torch.stack(rows)
        got = torch.stack(grads["card"][path])
        err = float((got - want).abs().max() / want.abs().max().clamp_min(
            1e-30))
        if err > worst:
            worst, at = err, path
    out["grad_worst"], out["grad_worst_leaf"] = worst, at
    rel = {k: abs(out["card"][k] / out["cpu"][k] - 1) for k in ("loss",
                                                                "gnorm")}
    out["rel"] = rel
    print(f"{tag}: {depth} layers, B={b} S={s}: card step {out['card_s']:.3f}"
          f" s, CPU {out['cpu_s']:.3f} s; loss {out['card']['loss']:.6f} vs "
          f"{out['cpu']['loss']:.6f} (rel {rel['loss']:.2e}), gnorm "
          f"{out['card']['gnorm']:.6f} vs {out['cpu']['gnorm']:.6f} (rel "
          f"{rel['gnorm']:.2e}); worst leaf gradient {worst:.2e} of its "
          f"largest |g| at {at} (tolerance {TRAIN_GRAD_TOL}) [{smi}]",
          flush=True)
    check(rel["loss"] <= 1e-5 and rel["gnorm"] <= 1e-5
          and worst <= TRAIN_GRAD_TOL,
          f"{tag}: the card's step differs from the CPU's")
    del card, cpu, grads
    torch.cuda.empty_cache()
    return out


def _ssm_train(device, smi: str) -> dict:
    """(c) mamba2-1.3b at full depth: adamw steps (the SSD's backward)."""
    import gc

    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers, schedule

    arch, b, s, n = TRAIN_SSM
    cfg = configs.get_config(arch)
    tag = f"train {cfg.name} B={b}"
    params = T.init_params(0, cfg, device)
    n_params = sum(p.numel() for p in params.parameters())
    opt = optimizers.adamw(schedule.cosine_schedule(3e-4, warmup=1,
                                                    total=n))
    batch = synthetic_token_stream(0, cfg.vocab, b, s, device)(0)
    params, state, recs = _train_steps(tag, cfg, params, opt, None, batch,
                                       range(1, n + 1), device, smi)
    retake = _retake_device(tag, cfg, params, opt, state, batch, recs,
                            device, smi)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "batch": b, "seq": s,
            "params_b": n_params / 1e9, "steps": recs, "retake": retake}


def _leaf_deltas(a: Path, b: Path) -> dict:
    """Largest |Δ| of each leaf between two checkpoint directories."""
    manifest = json.loads((a / "manifest.json").read_text())
    out = {}
    for e in manifest["leaves"]:
        x, y = (np.load(d / e["file"]) for d in (a, b))
        if e["dtype"] == "bfloat16":
            x, y = ((v.astype(np.uint32) << 16).view(np.float32)
                    for v in (x, y))
        out[e["path"]] = float(np.abs(x.astype(np.float64)
                                      - y.astype(np.float64)).max())
    return out


def _cli_train(smi: str) -> dict:
    """(d) whisper-small through ``python -m repro_torch.launch.train`` on
    the card: an uninterrupted run, and beside it a run stopped after its
    step-``stop`` checkpoint, then resumed; their final checkpoints
    compared leaf by leaf."""
    c = TRAIN_CLI
    root = ROOT / "build" / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            c["arch"], "--batch", str(c["batch"]), "--seq", str(c["seq"]),
            "--steps", str(c["steps"]), "--ckpt-every", str(c["every"]),
            *c["extra"]]

    def run(*more):
        return subprocess.Popen(argv + list(more), cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def done(name, proc):
        so, se = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"train cli {name}: exit "
              f"{proc.returncode}: {se[-3000:]}")
        return so

    tw = time.perf_counter()
    full = run("--ckpt-dir", str(root / "a"))
    outs = {"stopped": done("stopped", run("--ckpt-dir", str(root / "b"),
                                           "--stop-at", str(c["stop"])))}
    resumed = run("--ckpt-dir", str(root / "b"))       # beside the full run
    outs["full"] = done("full", full)
    outs["resumed"] = so = done("resumed", resumed)
    wall = time.perf_counter() - tw
    check(f"resumed from step {c['stop']}" in so, "train cli: the second "
          f"run did not resume: {so[-2000:]}")
    check(all("device: cuda" in o for o in outs.values()),
          "train cli: a run was not on the card")
    check(all("mesh: {'data': 1, 'model': 1}" in o for o in outs.values()),
          "train cli: a run did not take the 1×1 mesh")
    final = f"step_{c['steps']:08d}"
    deltas = _leaf_deltas(root / "a" / final, root / "b" / final)
    worst = max(deltas.items(), key=lambda kv: kv[1])
    for name, o in outs.items():
        print(f"train cli {name}: " + " | ".join(
            line.strip() for line in o.splitlines() if line.startswith(
                ("device", "step", "resumed"))), flush=True)
    print(f"train cli {c['arch']}: {c['steps']} steps uninterrupted and "
          f"{c['stop']} + resumed to {c['steps']} (B={c['batch']}, "
          f"S={c['seq']}, a checkpoint every {c['every']}) in {wall:.1f} s; "
          f"largest |Δ| between the final checkpoints' leaves "
          f"{worst[1]:.3e} at {worst[0]}; "
          f"{sum(v == 0 for v in deltas.values())} of {len(deltas)} leaves "
          f"equal [{smi}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"arch": c["arch"], "wall_s": wall, "max_abs_delta": worst[1],
            "max_abs_delta_leaf": worst[0],
            "leaves_equal": sum(v == 0 for v in deltas.values()),
            "leaves": len(deltas)}


def phase_train(device) -> dict:
    """Training through ``launch.steps.make_train_step`` and the train CLI
    on the card: granite-3-2b (a, a' on a 1×1 mesh, b), mamba2-1.3b (c),
    deepseek-v3 at depth 1 on a 1×1 mesh (e), mamba2-1.3b (f) and zamba2-7b
    at a reckoned depth (g) on a 1×1 mesh, whisper-small (h) and
    llama-3.2-vision-11b at 10 layers (i) on a 1×1 mesh, whisper-small
    through the CLI (d).
    The flash kernel's launch count stays 0 (training takes the reference's
    ``_sdpa`` route)."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    smi = nvidia_smi()
    ops.reset_launches()
    out = {"card": smi}
    parts = (("granite", _granite_train),
             ("mesh", lambda d, m: _mesh_train(d, m, out["granite"][
                 "batch"])),
             ("fp32_check", _fp32_check), ("ssm", _ssm_train),
             ("moe", _moe_train), ("ssm_mesh", _ssm_mesh_train),
             ("hybrid_mesh", _hybrid_train),
             ("whisper_mesh", _whisper_mesh_train),
             ("vlm_mesh", _vlm_mesh_train))
    for name, part in parts:
        tp = time.perf_counter()
        out[name] = part(device, smi)
        out[name]["part_s"] = time.perf_counter() - tp
        print(f"train {name}: {out[name]['part_s']:.1f} s", flush=True)
    launches = ops.launch_counts()["flash_attention"]
    check(launches == 0, f"train: flash_attention launched {launches} "
          "times in training")
    out["flash_launches"] = launches
    out["cli"] = _cli_train(smi)
    print("train:", json.dumps(out), flush=True)
    _phase("train", t0)
    return out


def _launcher_request(proc, gateway) -> dict:
    """The gateway launcher's one request: wait for its URL, ask for phase
    gateway's first job by the store's name under ``--store-root`` and
    hold the samples against the in-process job's."""
    from repro_torch.runtime import transport

    tw = time.perf_counter()
    url = None
    for line in proc.stdout:
        if line.startswith("gateway listening on "):
            url = line.split()[-1]
            break
    check(url is not None, f"gateway launcher printed no URL: "
          f"{proc.stderr.read()[-3000:] if proc.poll() is not None else ''}")
    up = time.perf_counter() - tw
    client = _GatewayClient(url)
    code, _, sub = client.submit(gateway["name"], GATEWAY_SEED,
                                 {"segment_len": 1})
    check(code == 201, f"gateway launcher: submit answered {code} {sub}")
    frames, term = client.stream_frames(sub["id"])
    client.close()
    check(term["kind"] == "end", f"gateway launcher: {term}")
    got = np.concatenate([transport.array_from_frame(f) for f in frames])
    check(np.array_equal(got, gateway["samples"]),
          "gateway launcher: its samples differ from the in-process job's")
    out = {"up_s": up, "request_s": time.perf_counter() - tw - up}
    print(f"cli gateway launcher: up in {out['up_s']:.3f} s, one request "
          f"for {gateway['name']} by name == the in-process job in "
          f"{out['request_s']:.3f} s", flush=True)
    return out


def phase_cli(gateway) -> dict:
    """The sampling CLI on the card, its runs all started at once: plain;
    ``--clamp 1=0,3=1``; ``--service --service-workers 2`` (thread lanes,
    the default dp scheme), which writes the plain run's batch files;
    ``--service-fleet`` and ``--runtime remote`` (a worker process on the
    card each, which places its walk itself: seq), which write the seq
    walks' on the same batch keys, with the workers' kernel launches
    reported; ``repro_torch.launch.scenarios``; and ``repro_torch.launch.
    gateway --port 0 --serve-s`` over phase gateway's 2-site store, which
    serves one request for it by name (the in-process job's samples)."""
    from repro_torch import api
    from repro_torch.core import mps as M
    from repro_torch.core import prng

    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    sample = [sys.executable, "-m", "repro_torch.launch.sample", "--sites",
              "8", "--chi", "256", "--d", "4", "--samples", "4096",
              "--macro-batches", "2"]
    with tempfile.TemporaryDirectory(dir=build) as out:
        runs = {"plain": sample + ["--out", out],
                "clamped": sample + ["--clamp", "1=0,3=1", "--out",
                                     os.path.join(out, "clamped")]}
        flags = {"service": ["--service", "--service-workers", "2"],
                 "fleet": ["--service-fleet"],
                 "remote": ["--runtime", "remote"]}
        for name, f in flags.items():
            runs[name] = sample + ["--out", os.path.join(out, name), *f]
        runs["scenarios"] = [sys.executable, "-m",
                             "repro_torch.launch.scenarios", "--scenario",
                             "all", "--json", ""]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for name, cmd in runs.items()}
        launcher = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.gateway", "--port",
             "0", "--serve-s", "600", "--workers", "1", "--stats-every",
             "0", "--store-root", gateway["store_root"]], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            served = _launcher_request(launcher, gateway)
            launcher.terminate()
            launcher.communicate(timeout=120)
            # the seq walks on the CLI's chain and batch keys, meanwhile
            device = torch.device("cuda", torch.cuda.current_device())
            chain = M.gbs_like_mps(prng.key(0), 8, 256, 4,
                                   dtype=torch.float64, device=device)
            with api.SamplingSession(chain, api.SamplerConfig(
                    kernels="cuda"), device=device) as session:
                seq = [session.sample(2048, prng.fold_in(prng.key(1), b))
                       for b in (0, 1)]
            res = {name: proc.communicate(timeout=600)
                   for name, proc in procs.items()}
        finally:
            for proc in [*procs.values(), launcher]:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(f"cli: {len(runs) + 1} runs at once in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        stdout, stderr = res["plain"]
        print(stdout[-1500:])
        check(procs["plain"].returncode == 0,
              f"CLI exited {procs['plain'].returncode}: {stderr[-3000:]}")
        for b in (0, 1):
            check(os.path.exists(os.path.join(out, f"batch_{b:05d}.npy")),
                  f"CLI wrote no batch {b}")
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("kernel launches:")]
        check(len(line) == 1, "CLI printed no launch counts")
        counts = json.loads(line[0].split(":", 1)[1])
        check(counts["site_step_linear"] > 0,
              f"CLI launched no kernel: {counts}")

        stdout, stderr = res["clamped"]
        print(stdout[-1500:])
        check(procs["clamped"].returncode == 0,
              f"clamped CLI exited {procs['clamped'].returncode}: "
              f"{stderr[-3000:]}")
        lines = stdout.splitlines()
        counts = json.loads([ln for ln in lines if ln.startswith(
            "kernel launches:")][0].split(":", 1)[1])
        check(counts["contract_measure"] == 16 and
              counts["site_step_linear"] == 0,
              f"clamped CLI launches {counts}, expected contract_measure "
              f"× 16 (8 sites, 2 batches)")
        check(any(ln.startswith("clamp log_prob: n=4096") for ln in lines),
              "clamped CLI printed no log_prob line")
        batch = np.load(os.path.join(out, "clamped", "batch_00000.npy"))
        check(bool((batch[:, 1] == 0).all() and (batch[:, 3] == 1).all()),
              "clamped CLI: the clamp does not hold in batch 0")

        plain = [np.load(os.path.join(out, f"batch_{b:05d}.npy"))
                 for b in (0, 1)]
        for name, f in flags.items():
            want = plain if name == "service" else seq
            stdout, stderr = res[name]
            lines = stdout.splitlines()
            print("\n".join(ln for ln in lines if ln.startswith(
                ("[service]", "worker kernel launches", "runtime counters",
                 "kernel launches")))[-1500:])
            check(procs[name].returncode == 0, f"CLI {' '.join(f)} exited "
                  f"{procs[name].returncode}: {stderr[-3000:]}")
            for b in (0, 1):
                got = np.load(os.path.join(out, name, f"batch_{b:05d}.npy"))
                check(np.array_equal(got, np.asarray(want[b]).astype(
                    np.int8)), f"CLI {' '.join(f)}: batch {b} differs from "
                    f"the {'plain run' if name == 'service' else 'seq walk'}")
            counts = json.loads([ln for ln in lines if ln.startswith(
                "worker kernel launches:" if name != "service" else
                "kernel launches:")][0].split(":", 1)[1])
            check(counts["site_step_linear"] == 16, f"CLI {' '.join(f)}: "
                  f"launches {counts}, expected site_step_linear × 16")
            print(f"cli {' '.join(f)}: batch files == the "
                  f"{'plain run' if name == 'service' else 'seq walks'}; "
                  f"launches {counts}", flush=True)

        stdout, stderr = res["scenarios"]
        print(stdout[-2500:])
        check(procs["scenarios"].returncode == 0
              and stdout.count("[PASS]") == 3,
              f"scenarios exited {procs['scenarios'].returncode}: "
              f"{stdout[-2000:]} {stderr[-2000:]}")
    _phase("cli", t0)
    return served


def dryrun_start() -> dict:
    """Start phase dryrun's children: plain (the GBS cells and
    ``DRYRUN_LM_ARCH``'s) and ``--gbs-opt`` on the card's fake tensors, and
    the LM cells again on the CPU's; each MoE arch's decode_32k cell on
    16×16 at full depth on the card's fakes (``DRYRUN_MOE_ARCHS``); the SSM,
    hybrid, encoder-decoder and VLM cells of ``DRYRUN_PAIRED`` on the
    card's fakes and again on the CPU's; each writes its log and its JSONs
    under ``build/dryrun_torch/`` (the CPU's under ``cpu/``)."""
    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    (out / "cpu").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    lm = ["--arch", DRYRUN_LM_ARCH]
    gbs = ["--preset", DRYRUN_PRESET]
    rb = [*lm, "--shape", "train_4k", "--remat-block",
          str(DRYRUN_REMAT_BLOCK)]
    args = {"--gbs": ["--gbs", *gbs, *lm, "--out", str(out), *DRYRUN_ARGS],
            "--gbs-opt": ["--gbs-opt", *gbs, *rb, "--out", str(out),
                          *DRYRUN_ARGS],
            "cpu": [*lm, "--out", str(out / "cpu"), "--device", "cpu"],
            "cpu-rb": [*rb, "--out", str(out / "cpu"), "--device", "cpu"]}
    for arch in DRYRUN_MOE_ARCHS:     # full depth, on the card's fakes
        args[f"moe-{arch}"] = ["--arch", arch, "--shape", "decode_32k",
                               "--out", str(out), *DRYRUN_ARGS]
    for pre, table in DRYRUN_PAIRED.items():   # full depth, card and CPU
        for arch, shapes in table.items():
            cells = ["--arch", arch,
                     *(a for shape in shapes for a in ("--shape", shape))]
            args[f"{pre}-{arch}"] = [*cells, "--out", str(out),
                                     *DRYRUN_ARGS]
            args[f"cpu-{pre}-{arch}"] = [*cells, "--out", str(out / "cpu"),
                                         "--device", "cpu"]
    children = {}
    for flag, more in args.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--mesh", "single", "--force", *more]
        t0 = time.perf_counter()
        with open(out / f"{flag.lstrip('-')}.log", "w") as log:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
        rec = {"proc": proc, "log": out / f"{flag.lstrip('-')}.log",
               "t0": t0}
        rec["watch"] = threading.Thread(target=_dryrun_watch, args=(rec,),
                                        daemon=True)
        rec["watch"].start()
        children[flag] = rec
    return {"out": out, "children": children}


def _dryrun_watch(rec: dict) -> None:
    rec["proc"].wait()
    rec["wall_s"] = time.perf_counter() - rec["t0"]


def dryrun_stop(started: dict) -> None:
    """Kill a child still running (a phase before this one failed)."""
    for rec in started["children"].values():
        if rec["proc"].poll() is None:
            rec["proc"].kill()
            rec["proc"].wait()


def _lm_lines(text: str, arch: str = DRYRUN_LM_ARCH) -> list[str]:
    """``arch``'s cells' ``summarize`` lines of a child's log, each without
    its walk time (``compile=…``)."""
    return [re.sub(r" compile=\S+$", "", ln) for ln in text.splitlines()
            if ln.startswith(arch)]


def phase_dryrun(started: dict) -> dict:
    """Read the three children: their summaries, wall times, each GBS
    cell's FLOPs against the closed form, the LM cells' lines and counts
    against the CPU child's, and the device memory the card's children
    allocated."""
    from repro_torch.configs import gbs
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    preset = gbs.PRESETS[DRYRUN_PRESET]
    result = {}
    texts = {}
    for flag, rec in started["children"].items():
        left = DRYRUN_SECONDS - (time.perf_counter() - rec["t0"])
        rec["watch"].join(timeout=max(left, 1.0))
        if rec["watch"].is_alive():
            dryrun_stop(started)
            check(False, f"dryrun {flag}: still running after "
                  f"{DRYRUN_SECONDS} s")
        text = texts[flag] = rec["log"].read_text()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("gbs-", DRYRUN_LM_ARCH,
                                   *DRYRUN_MOE_ARCHS, *DRYRUN_SSM,
                                   *DRYRUN_XATTN))]
        for ln in lines:
            print(f"dryrun {flag}: {ln}", flush=True)
        print(f"dryrun {flag}: child wall {rec['wall_s']:.1f} s, exit "
              f"{rec['proc'].returncode}", flush=True)
        want = {"--gbs": len(DR.SCHEMES) + len(DRYRUN_LM_SHAPES),
                "--gbs-opt": len(DR.SCHEMES) + 1,
                "cpu": len(DRYRUN_LM_SHAPES), "cpu-rb": 1,
                **{f"{cpu}{pre}-{a}": len(shapes)
                   for pre, table in DRYRUN_PAIRED.items()
                   for a, shapes in table.items()
                   for cpu in ("", "cpu-")}}.get(flag, 1)
        check(rec["proc"].returncode == 0 and len(lines) == want
              and " ok " in " ".join(lines),
              f"dryrun {flag} exited {rec['proc'].returncode}: "
              f"{text[-3000:]}")
        if flag.startswith("cpu"):
            continue
        peak = re.search(r"peak device memory allocated: (\d+) bytes.*",
                         text)
        print(f"dryrun {flag}: {peak and peak.group(0)}", flush=True)
        check(peak is not None and int(peak.group(1)) == 0,
              f"dryrun {flag}: the child allocated device memory "
              f"({peak and peak.group(0)})")
        if flag.startswith(tuple(f"{pre}-" for pre in DRYRUN_PAIRED)):
            # held against the CPU's below
            result[flag] = {"wall_s": rec["wall_s"], "peak_allocated": 0}
            continue
        if flag.startswith("moe-"):
            arch = flag[len("moe-"):]
            r = json.loads((started["out"] / f"{arch}__decode_32k__single"
                            ".json").read_text())
            check("error" not in r, f"dryrun {flag}: {r.get('error')}")
            result[flag] = {
                "wall_s": rec["wall_s"], "peak_allocated": 0,
                "flops_per_device": r["hlo"]["flops_per_device"],
                "n_collectives": r["hlo"]["n_collectives"],
                "bytes_per_device": r["bytes_per_device"],
                "roofline": r["roofline"], "walk_s": r["compile_s"]}
            print(f"dryrun {flag}: decode_32k on 16x16 at full depth: "
                  f"{json.dumps(result[flag])} [{nvidia_smi()}]", flush=True)
            continue
        opt = flag == "--gbs-opt"
        cells = {}
        for scheme in DR.SCHEMES:
            path = started["out"] / (f"gbs-{DRYRUN_PRESET}__{scheme}"
                                     f"{'_opt' if opt else ''}__single.json")
            r = json.loads(path.read_text())
            check("error" not in r, f"dryrun {path.name}: {r.get('error')}")
            want = DR.gbs_flops(preset, scheme, opt, r["n_samples"] // (
                256 if scheme == "dp" else 16))
            got = r["hlo"]["flops_per_device"]
            check(got == want, f"dryrun {path.name}: flops_per_device {got} "
                  f"!= the closed form {want}")
            cells[scheme] = {"flops_per_device": got,
                             "bytes_per_device": r["bytes_per_device"],
                             "n_collectives": r["hlo"]["n_collectives"],
                             "walk_s": r["compile_s"],
                             "roofline": r["roofline"]}
        result[flag[2:]] = {"wall_s": rec["wall_s"], "peak_allocated": 0,
                            "cells": cells}
    # the SSM, hybrid, encoder-decoder and VLM cells: the card's fake
    # tensors count what the CPU's count
    for flag, arch, shapes in ((f"{pre}-{a}", a, shapes)
                               for pre, table in DRYRUN_PAIRED.items()
                               for a, shapes in table.items()):
        card, cpu = (_lm_lines(texts[f], arch) for f in (flag, "cpu-" + flag))
        check(card == cpu and len(card) == len(shapes),
              f"dryrun {flag}: the card's lines {card} != the CPU's {cpu}")
        cells = {}
        for shape in shapes:
            name = f"{arch}__{shape}__single.json"
            r, c = (json.loads(p.read_text()) for p in
                    (started["out"] / name, started["out"] / "cpu" / name))
            check("error" not in r and "skipped" not in r and all(
                r[k] == c[k] for k in ("hlo", "bytes_per_device",
                                       "roofline")),
                  f"dryrun {name}: {r.get('error')}, or the card's counts "
                  f"differ from the CPU's")
            cells[shape] = {
                "flops_per_device": r["hlo"]["flops_per_device"],
                "n_collectives": r["hlo"]["n_collectives"],
                "bytes_per_device": r["bytes_per_device"],
                "roofline": r["roofline"], "walk_s": r["compile_s"]}
        result[flag].update(
            cells=cells,
            wall_s_cpu=started["children"]["cpu-" + flag]["wall_s"])
        print(f"dryrun {flag}: 16x16 at full depth, the card's counts equal "
              f"to the CPU's: {json.dumps(result[flag])} [{nvidia_smi()}]",
              flush=True)
    # the LM cells: the card's fake tensors count what the CPU's count
    for card_flag, cpu_flag, n in (("--gbs", "cpu", len(DRYRUN_LM_SHAPES)),
                                   ("--gbs-opt", "cpu-rb", 1)):
        card, cpu = _lm_lines(texts[card_flag]), _lm_lines(texts[cpu_flag])
        check(card == cpu and len(card) == n,
              f"dryrun {DRYRUN_LM_ARCH}: the card's lines {card} != the "
              f"CPU's {cpu}")
    lm = {}
    cells = [(shape, "") for shape in DRYRUN_LM_SHAPES]
    cells.insert(1, ("train_4k", f"__rb{DRYRUN_REMAT_BLOCK}"))
    for shape, rb in cells:
        name = f"{DRYRUN_LM_ARCH}__{shape}{rb}__single.json"
        r, c = (json.loads(p.read_text()) for p in
                (started["out"] / name, started["out"] / "cpu" / name))
        if "skipped" in r:
            check(r == c, f"dryrun {name}: {r} != the CPU's {c}")
            lm[shape + rb] = {"skipped": r["skipped"]}
            continue
        check("error" not in r and "error" not in c,
              f"dryrun {name}: {r.get('error')} / {c.get('error')}")
        same = all(r[k] == c[k] for k in ("hlo", "bytes_per_device",
                                          "roofline"))
        check(same, f"dryrun {name}: the card's counts differ from the "
              "CPU's")
        lm[shape + rb] = {"flops_per_device": r["hlo"]["flops_per_device"],
                     "n_collectives": r["hlo"]["n_collectives"],
                     "bytes_per_device": r["bytes_per_device"],
                     "roofline": r["roofline"], "walk_s": r["compile_s"]}
    result["lm"] = {"arch": DRYRUN_LM_ARCH, "mesh": "16x16",
                    "wall_s_cpu": started["children"]["cpu"]["wall_s"],
                    "wall_s_cpu_rb": started["children"]["cpu-rb"]["wall_s"],
                    "cells": lm}
    _phase("dryrun", t0)
    return result


def main() -> int:
    device = phase_device()
    ptxas, mma = phase_build()
    dryrun = dryrun_start()
    try:
        return _main(device, ptxas, mma, dryrun)
    finally:
        dryrun_stop(dryrun)


def _main(device, ptxas, mma, dryrun) -> int:
    import torch.distributed as dist

    from repro_torch.obs import MetricsRegistry

    phase_small(device)
    mesh = phase_nccl(device)
    registry = MetricsRegistry()
    gateway = None
    try:
        stream = phase_stream(device, mesh, registry)
        gateway = stream["gateway"]
        linear, mps, env = phase_full(device, "linear")
        walks = phase_tp(mesh, mps)
        clamp = phase_clamp(mesh, mps)
        service = phase_service(mps, stream.pop("service"), registry)
        tp_entries = phase_tp_kernels(device, mps, env, walks)
        bf16_entries = phase_bf16(device, mesh, mps)
        del mps, env
        torch.cuda.empty_cache()
        born, mps, _ = phase_full(device, "born")
        phase_tp_born(mesh, mps)
        clamp["e"] = phase_clamp_born(mps)
        del mps
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    displacement = phase_displacement(device)
    flash_rows = phase_flash(device)
    lm = phase_lm(device)
    moe = phase_moe(device)
    ssm = phase_ssm(device)
    xattn = phase_xattn(device)
    train = phase_train(device)
    whisper, vlm = (xattn[a] for a in XATTN_ARCHS)
    flash = dict(flash_rows[0], name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:111",
                 launches=lm["flash_launches"], other_shapes=flash_rows[1:],
                 kimi_k2_launches=moe["kimi-k2-1t-a32b"]["flash_launches"],
                 kimi_k2_sharded_launches=moe["kimi-k2-1t-a32b"][
                     "mesh_1x1"]["flash_launches"],
                 zamba2_launches=ssm["zamba2-7b"]["flash_launches"],
                 zamba2_sharded_launches=ssm["zamba2-7b"]["mesh_1x1"][
                     "flash_launches"],
                 whisper_launches={
                     "prefill": whisper["flash_launches"],
                     "encode": whisper["encode_launches"],
                     "decode_step": whisper["serve_launches"]
                     // SERVE["max_new"]},
                 vlm_launches={
                     "prefill": vlm["flash_launches"],
                     "decode_step": vlm["serve_launches"]
                     // SERVE["max_new"]},
                 whisper_sharded_launches={
                     "prefill": whisper["mesh_1x1"]["flash_launches"],
                     "encode": whisper["mesh_1x1"]["encode_launches"],
                     "decode_step": whisper["mesh_1x1"]["serve_launches"]
                     // SERVE["max_new"]},
                 vlm_sharded_launches={
                     "prefill": vlm["mesh_1x1"]["flash_launches"],
                     "decode_step": vlm["mesh_1x1"]["serve_launches"]
                     // SERVE["max_new"]},
                 xattn_shapes=xattn.pop("rows"),
                 train_launches=train["flash_launches"],
                 lm=lm, moe=moe, ssm=ssm, xattn=xattn)
    try:
        gateway["launcher"] = phase_cli(gateway)
    finally:
        shutil.rmtree(gateway["store_root"], ignore_errors=True)
    del gateway["samples"]
    dry = phase_dryrun(dryrun)
    for entry, prefix in ((linear, "collapse_f64_kernel"),
                          (born, "contract_c128_kernel"),
                          (tp_entries[0], "contract_f64_kernel"),
                          (tp_entries[2], "collapse_f64_kernel"),
                          (tp_entries[1], "measure_probs_kernel"),
                          (bf16_entries[2], "measure_probs_kernel"),
                          (bf16_entries[0], "wgmma_bf16_kernel"),
                          (bf16_entries[1], "wgmma_bf16_kernel"),
                          (bf16_entries[3], "wgmma_bf16_kernel"),
                          (flash, "flash_tc_kernel")):
        entry["ptxas"] = {k: v for k, v in ptxas.items()
                          if k.startswith(prefix)}
        if prefix.endswith("f64_kernel") or prefix.endswith("c128_kernel"):
            entry["dmma_instructions"] = {
                k: v["DMMA"] for k, v in mma.items() if k.startswith(prefix)}
        if prefix == "wgmma_bf16_kernel":
            entry["sass"] = {k: v for k, v in mma.items()
                             if k.startswith(prefix)}
    # the streamed walks' launches (phase stream), beside each entry's own
    linear["stream_launches"] = {"seq": stream["flat"]["launches"],
                                 "dyn_chi": stream["dyn"]["launches"]}
    for entry in tp_entries:
        entry["stream_launches"] = {
            label: w["launches"][entry["name"]]
            for label, w in stream["tp"].items()
            if entry["name"] in w["launches"]}
    tp_entries[0]["clamp_launches"] = {
        "seq": clamp["a"]["launches"]["contract_measure"],
        "seq_per_sample": clamp["b"]["launches"]["contract_measure"],
        **{label: w["launches"]["contract_measure"]
           for label, w in clamp["d"].items()}}
    tp_entries[0]["other_shapes"].append(
        dict(clamp.pop("square"), launches=clamp["a"]["launches"][
            "contract_measure"]))
    tp_entries[0]["clamp"] = clamp
    streamed = service["streamed"]
    linear["service_launches"] = {
        "session": service["a"]["launches"]["site_step_linear"],
        "lanes": service["b"]["lanes"][str(SERVICE_LANES)]["launches"][
            "site_step_linear"],
        "fleet_workers": streamed["fleet"]["worker_launches"][
            "site_step_linear"],
        "remote_worker": streamed["remote"]["worker_launches"][
            "site_step_linear"],
        "gloo_ranks": [r["site_step_linear"]
                       for r in streamed["gloo"]["launches"]]}
    tp_entries[0]["service_launches"] = {
        "clamped_job": service["b"]["clamped_launches"]["contract_measure"]}
    # the sharded plane's and the gateway's walks (phase shard, gateway)
    shard = stream["shard"]
    linear["shard_launches"] = {
        **{f"emulated_{h}": shard[f"emulated_{h}"]["launches"][
            "site_step_linear"] for h in SHARD_HOSTS},
        "gloo_ranks": [r["launches"]["site_step_linear"]
                       for r in shard["gloo"].values()],
        "repair_ranks": [r.get("site_step_linear", 0)
                         for r in shard["repair_launches"]]}
    linear["gateway_launches"] = gateway["launches"]["site_step_linear"]
    tp_entries[0]["shard_launches"] = {
        "clamped_emulated_2": shard["clamped"]["launches"][
            "contract_measure"]}
    print("stream:", json.dumps(stream))
    print("service:", json.dumps(service))
    print("dryrun:", json.dumps(dry))
    entries = [linear, born, *tp_entries, *bf16_entries, displacement,
               flash]
    print("kernels:", json.dumps(entries))
    print(nvidia_smi())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
