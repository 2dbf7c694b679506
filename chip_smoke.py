#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and hold every
kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero (without a card, or without the repository's ``src/``, it
fails before printing any result):

  device     the card's name and count, ``nvidia-smi`` name and power limit,
             and the matmul precision settings (TF32 off, no reduced-
             precision bf16 reductions)
  build      the four CUDA kernels compiled from ``src/repro_torch/csrc``
             for sm_90a, one nvcc per source in parallel, with the
             ``-Xptxas -v`` register / spill report; the instantiations of
             each kernel counted, and in ``cuobjdump -sass`` the tensor-core
             MMAs of each bf16 flash instantiation (HMMA / HGMMA) and of
             each W4A8 instantiation (IMMA): none is a failure; the scan's
             FMUL / FADD / FFMA counts are reported (its state update has
             no FFMA: the card phase checks the state bit for bit)
  sanitizer  compute-sanitizer memcheck and racecheck over one card test
             of each kernel: a reported error, a failed test or a timeout
             fails the run; the tool is reported as not run only where its
             first message is "Error: Device not supported" and no test
             under it passed
  w4a8       the W4A8 kernel on the codes packed two per byte
             (``pack_codes``) against the plain version on the int8 codes
             at every main-path (K, N) of tinyllama-1.1b for M in {1, 8},
             llama2-7b's shapes (also at M 4, examples_path (b)'s batch)
             and ragged shapes: bit-identical; one call
             is one device kernel (torch.profiler over single calls)
  paged      the paged flash-decode kernel against the plain version at
             tinyllama's, llama2-7b's and gemma2-27b's attention shapes
             (32/16 heads of 128, softcap 50, window 4096, lengths crossing
             4096), with window, softcap, int8 and fp8 pools, with
             return_lse: bf16 within one bf16 ulp of the plain value plus
             the order bound, f32 within 1e-5, the LSE within 1e-5 (at most
             -1e29 for an empty slot)
  flash      the flash-attention kernel against the plain version at
             llama2-7b's prefill shapes (T in {1, 37, 512}), tinyllama's
             (GQA 32/4, D 64, T 300), non-causal with kv_offset, window 64
             with softcap 30, gemma2-27b's (32/16 heads of 128, softcap 50,
             window 4096, T 4,084 and 4,200), seamless-m4t-medium's
             encoder (B 4, 16/16 heads of 64, T 960, non-causal) and
             llama-3.2-vision-11b's cross blocks (B 4, 32/8 heads of 128,
             Tq 127 and 1, Tk 1,600, non-causal), in f32 and bf16: f32
             within 1e-5, bf16 within one bf16 ulp of the plain value plus
             that 1e-5 (an output near zero has a bf16 ulp below the f32
             sum-order error)
  rwkv       the RWKV6 WKV-scan kernel against the plain version at
             rwkv6-7b's forward shape (B 4, H 64, D 64, bf16, T in {1, 37,
             512}), at the JAX kernel tests' shapes in f32 and at bf16
             cases with B 1 (H 64, and H 3 / 5 at D 16 / 32): the final
             state bit-identical, f32 outputs within 1e-4, bf16 outputs
             within one bf16 ulp of the plain value plus the f32 bound of
             two orders of out's D-term sum (its terms reach hundreds at
             T = 512)
  reference  reduced tinyllama split-brain engine served on the card
             (kernels) and on the CPU (plain versions) from the same
             weights, and its generate() (fused and stepwise, with a stop
             token): identical tokens; and the KV-cache features
             (REFERENCE_FEATURES: an int8 prefix-shared pool with chunked
             prefill, fp8 with the gather discipline, a dense slot cache)
             on a shared-prefix traffic: identical tokens and cached tokens
  reference_serve  reduced llama2-7b, tinyllama, gemma2-27b, stablelm-1.6b,
             granite-8b and minitron-8b ServeEngine on the card and on the
             CPU, under the scheduler and generate() (gemma2's 16-token
             ring wrapped in decode, and prompts past it on the per-token
             prefill): identical tokens; then REFERENCE_FEATURES on the
             ServeEngine (llama2-7b: int8 / fp8 pools, prefix sharing,
             chunked and block prefill, gather and in place, the dense slot
             cache; gemma2-27b with an int8 pool): identical tokens and
             cached tokens
  reference_rwkv  reduced rwkv6-7b on the card and on the CPU from the
             same weights, over four weight seeds: forward logits within one
             bf16 ulp of the largest; the tokens the card's ServeEngine chose
             under the scheduler and generate(), fed back teacher-forced
             through the decode steps on both devices, give logits within
             two ulps, and any token the CPU would not choose is a near-tie
             (the bf16 GEMMs' sum orders differ between the devices); each
             op of the decay path run on both devices from the same inputs
             is reported, and the decay (float64 exps) must match bit for
             bit
  main_path  full-width tinyllama-1.1b at 6 of its 22 layers (random
             seeded weights, LAQ W4A8 on the card; MAIN_LAYERS, cut to
             keep the script inside its time limit; the times rows keep
             the 22-layer units), SplitBrainEngine(page_size=16,
             max_len=256) under the continuous-batching scheduler with 8
             slots: a warm-up run, then 16 seeded requests (prompts of 8-64
             tokens, 32 new tokens each) with the launch counts set to 0
             just before and read just after; every request DONE, launches
             = 43 W4A8 per token step (7 per layer and the head) and 6
             paged attentions per decode step, eq. 7-10 meter exact, a
             second run token-identical; then generate() on 4 prompts of 64
             tokens with 32 new tokens: 43 W4A8 launches per token step,
             its tokens/s
  tp_path    tensor-parallel serving on two ranks of a torch.distributed
             group sharing the one card over gloo (one process each; the
             ranks' devices and backend from ``runtime.plan``): (a) the main
             path at tp 2, full-width tinyllama-1.1b split-brain (main_path's
             6 layers,
             LAQ W4A8 column blocks of wq/wk/wv/w1/w3 and the head, packed
             per rank; wo/w2 whole), page 16, 8 slots, 8 of main_path's
             requests with 32 new: tokens identical to main_path's (the tp 1
             engine on the same requests), 43 W4A8 and 6 paged launches
             per rank per token step, the meter's bytes per token eq.
             7-10's, kv_shards 2; (b) the float ServeEngine, llama2-7b at
             full width and 8 of its 32 layers (bf16 weights), 8 requests of
             64-256 tokens with 16 new: 8 flash launches per prefill and 8
             paged per decode step per rank, tokens against a tp 1 engine of
             the same depth served here (identical, or parting only at a
             near-tie, reported); (c) the paged kernel's TP dispatch: the
             page-split LSE merge (Hkv 1, Hq 32, D 128, ps 16, B 8, lengths
             up to 1,024) within phase_paged's bf16 bound of the plain
             version, and the head cut (32/8 heads, the rank's 16/4) bit for
             bit the unsharded kernel's heads and within the same bound of
             the plain version on the rank's inputs; (d) qwen3-moe-235b-a22b
             at full width and 4 of its 94 layers (128 experts, top-8, whole
             on every rank), moe_path (b)'s 8 requests of 32-256 tokens with
             16 new on a paged pool: 4 flash launches per prefill and 4
             paged per decode step per rank, the ranks' picks and drop logs
             equal, tokens against a tp 1 engine of the same depth served
             here (identical, or at the first differing pick a near-tie in
             its logits); (e) llama-3.2-vision-11b at full width and 10 of
             its 40 layers (2 gated cross blocks, seeded gates): fused
             generate() on 2 x 64 with 16 new (12 flash launches per
             prefill, 2 per decode step) and stepwise on 2 x 16 with 8 new
             (2 per step), tokens against tp 1 by the same rule; (f)
             seamless-m4t-medium at full width, its 12 encoder and 6 of its
             12 decoder layers: fused generate() on 4 x 64 with 16 new (12
             flash launches, the encoder on the rank's 8 of 16 heads),
             tokens against tp 1; (g) on (a)'s
             engine fused and eager generate() on 4 x 16 with 8 new (43
             W4A8 launches per token step, the meter's bytes per token eq.
             7-10's, tokens identical to tp 1), and on (b)'s engine one
             scheduler run on two slots with priorities, preemption, a
             deadline and the chaos plan TP_ONLINE, rank 1 sleeping 4 ms an
             iteration so that its own clock runs apart: the ranks' tokens,
             request states and recovery events equal (the group's loop
             clock), every planned fault fired; (h) the sequence-cut dense
             decode (parallel.decode_attn="shard_map"): llama2-7b at (b)'s
             8 layers on a dense slot cache of 1,024 positions, a rank
             holding every KV head of its 512 (its K/V bytes reported
             beside (b)'s head-cut pool), 8 requests of 64-512 tokens with
             16 new: 8 flash launches per prefill per rank and no paged
             launch, the ranks' tokens equal, tokens against a tp 1 engine
             with the knob served here (identical, or parting only at a
             near-tie, reported); (i) the OnlineServer on (a)'s engine,
             one server per rank, rank 0 the front end: six requests from
             a client thread, streamed (one cancelled by the client after
             two tokens, one past its deadline, one whose consumer callback
             raises, one of a higher priority) and a decode step stalled
             4.5 s tripping a 3 s watchdog once: 43 W4A8 launches per token
             step per rank, streamed tokens equal to the results, the
             ranks' tokens, states and recovery events equal, tokens equal
             to a tp 1 OnlineServer's on the same requests.  The ranks' kernel shapes
             are also held to the plain versions in the kernel phases:
             w4a8 at (a)'s column blocks (W4A8_TP), paged at (a)'s, (b)'s
             and (d)'s head-cut pools (PAGED_TP_CASES), flash at (b)'s,
             (d)'s, (e)'s and (f)'s rank shapes (FLASH_TP_CASES), and the
             times phase times the new rank shapes.  Per rank: wall time
             and each part's seconds and peak memory, decode steps/s and
             its device busy share over profiled decode steps (its share
             of the card)
  serve_path full-width llama2-7b at 16 of its 32 layers (d_model 4096,
             bf16 weights from a seeded generator on the card), the float
             ServeEngine (page_size=16, max_len=1024) under the scheduler
             with 8 slots: a warm-up run, then 16 seeded requests (prompts
             of 64-512 tokens, 32 new tokens each), counts set to 0 just
             before and read just after: every request DONE, one flash
             launch per layer per prefill, one paged launch per layer per
             decode step, no W4A8 launch, meter exact, a second run
             token-identical; then generate() on 4 prompts of 128 tokens
             (one flash launch per layer, the same tokens on a second
             call)
  rwkv_path  full-width rwkv6-7b at 16 of its 32 layers (d_model 4096, 64
             heads of 64, d_ff 14336, vocab 65536; bf16 weights from a
             seeded generator on the card): api.forward on 4 x 512 tokens
             twice, counts set to 0 just before and read just after (16
             scan launches per call, finite logits, the second call
             bit-identical); then the
             float ServeEngine (max_len 128, dense slot cache) under the
             scheduler with 8 slots: a warm-up run, then 8 seeded requests
             (prompts of 16-64 tokens, 32 new tokens each), counts set to 0
             just before and read just after: every request DONE, no kernel
             launch (each decode step carries the WKV state, which the
             kernel does not take, as in the JAX package), meter exact, a
             second run token-identical
  gemma2_path  full-width gemma2-27b (46 layers, d_model 4608, 32/16 heads
             of 128, d_ff 36864, vocab 256000, tied embeddings, softcap 50
             and final softcap 30; bf16 weights drawn per layer slice from a
             seeded generator on the card), the float ServeEngine
             (page_size=16, max_len=8192: the 23 global layers page, the 23
             local layers keep slot-private 4096-token rings) under the
             scheduler with 4 slots, after the other paths have freed their
             memory: a warm-up run, then 8 requests (prompts of 4,070 and
             4,085 tokens and six of 256-1,024, 32 new tokens each), counts
             set to 0 just before and read just after: every request DONE,
             46 flash launches per prefill, 23 paged launches per decode
             step, both long requests past position 4096 (the rings wrap),
             meter exact, a second run token-identical; generate() on 2 x
             2,048 tokens (46 flash launches); rates, the busy share and
             peak memory printed beside the card's name and power limit
  features_path  full-width llama2-7b on the serve path's 16-layer
             weights (built once; ``with_paging`` gives each run its
             pool), pages of 16,
             max_len 1024, 8 slots, prefill chunks of 64, 16 requests (12
             share a 512-token prefix with tails of 16-128 tokens, 4 of
             64-256 share nothing; 32 new each), the first submitted alone
             and the rest once it decodes: runs (a) bf16 prefix off, (b)
             bf16 prefix on, (c) int8 prefix on, (d) fp8 prefix on.  Every
             request DONE; (a) and (b) token-identical; (b) at least 11
             hits of 512 cached tokens and fewer pages stored than (a);
             (c) and (d) hold exactly kv_token_bytes_quant bytes per pool
             token position and (b)'s boundary bytes; 16 paged launches per
             decode step in every run and no flash launch (chunks attend
             through the plain chunk_attention, as in the reference); the
             greedy flip rate of (c) and (d) against (b) as the JAX
             package's serve_bench counts it; rates and peak memory
  features_splitbrain  full-width tinyllama-1.1b split-brain on the main
             path's LAQ weights with an int8 prefix-shared pool (pages of
             16, chunks of 32) on the main path's traffic behind a shared
             128-token prefix: 43 W4A8 launches per computed token step,
             6 paged per decode step, meter exact; a short run on a dense
             slot cache (4 of the main path's requests, 8 new tokens) gives
             the tokens of a paged bf16 pool under the
             gather discipline (the same dense token step on the gathered
             view; in place, the paged kernel's sum order differs by an
             ulp, and that run's agreement is reported)
  chaos_path  both engines, reused, under seeded faults: (a) main_path's
             split-brain engine on main_path's 16 requests with a
             transient NaN corruption, a step error, a device loss and a
             cancellation burst; (b) 6 of serve_path's llama2-7b requests
             with a transient corruption and a device loss, against a
             fault-free run of the same requests in this call; (c)
             priority classes on two slots with preemption and a deadline
             (a victim evicted and resumed, a request TIMEOUT); (d) the
             OnlineServer with a 2 s watchdog, after a warm-up, and a decode
             step wedged for 5 s.  Every planned event fires, the pool is
             empty after every recovery, each request ends DONE (CANCELLED
             by the burst, TIMEOUT past its deadline) with the fault-free
             tokens or leaves them only at a near-tie (the two picks'
             logits, recomputed by the engine's own path from the common
             prefix, within NEAR_TIE_ULPS bf16 ulps of the largest), and
             the launches are pinned per step: 43 W4A8 per computed
             split-brain token step and 6 paged per decode step, 16 flash
             per llama2-7b prefill and 16 paged per decode step (16 layers)
  examples_path  the port's examples run on the card through their own
             ``run()`` (``examples/quickstart_torch.py`` and
             ``examples/serve_splitbrain_torch.py``), after main_path's
             engine is released: (a) the quickstart at main_path's
             full-width tinyllama-1.1b (6 of 22 layers, seeded weights): LAQ
             of the model, 8 ``decode_token`` steps from token 1, the
             hardware report of the full-size model from the wq codes;
             counts set to 0 just before and read just after: 43 W4A8
             launches per token step and no other kernel, the wq codes made
             on the card equal (``torch.equal``) to those made by the same
             run on the CPU from the same weights, the report and the pruned
             share equal to the CPU run's, the meter's bytes per token eq.
             7-10's exactly, the tokens the CPU run's or parting first at a
             near-tie (``pick_report``'s rule); (b) the serving example at
             full-width llama2-7b (4 of 32 layers, EXAMPLES_SERVE), 4
             prompts of 5 tokens, 12 new: 29 W4A8 launches per token step
             of the LAQ ``generate()`` and per batch-4 ``decode_token``, none
             in the float runs, the meter's bytes at batch 4 eq. 7-10's
             exactly; the float fused-against-stepwise and float-against-W4A8
             token agreements reported, as the JAX example prints them
  reference_hymba  reduced hymba-1.5b on the card and on the CPU from the
             same weights on a wrapping ring and on a paged pool, and
             forward: teacher-forced logits within two bf16 ulps (a
             differing pick a near-tie), forward within one; XLA's exp
             (``ref.exp``) the same bits on both
  hymba_path full-width hymba-1.5b at 8 of its 32 layers (d_model 1600,
             25/5 heads of 64, window 1024, SSM state 16; float32 weights
             from a seeded generator on the card): api.forward on 2 x 2,048
             tokens twice (8 flash launches per call, each layer's
             attention held against the plain version, the second call
             bit-identical);
             then the float ServeEngine (page 16, max_len 512: K/V page,
             the SSM state stays a dense slot leaf) under the scheduler
             with 8 slots on 8 requests of 32-128 prompt tokens (per-token
             prefill), 32 new each: every request DONE, one paged launch
             per layer per decode step and no flash launch, meter exact
  reference_moe  reduced phi3.5-moe-42b-a6.6b, reduced qwen3-moe-235b-a22b
             and the top-8 override (16 experts, top-8, GQA 16/1) on the
             card and on the CPU from the same weights, the two schedulers
             stepped in turn on paged pools with 4 slots (the MoE's
             capacity couples the decode rows), and generate(): tokens
             identical, or at the first differing pick a near-tie in the
             logits or the router, gaps reported
  moe_path   the MoE configs at every published width, cut in depth to fit
             one card (their full depth does not): (a) phi3.5-moe-42b-a6.6b
             (24 of 32 layers, 16 experts, top-2, 32/8 heads of 128) at
             page 16, max_len 1024, 8 slots, 16 requests of 64-512 prompt
             tokens and 32 new, then generate() on 4 x 128 twice; (b)
             qwen3-moe-235b-a22b (8 of 94 layers, 128 experts, top-8,
             64/4 heads of 64: the paged kernel's group 16) at max_len
             512, 8 requests of 32-256 tokens and 16 new.  bf16 weights
             drawn per slice from a seeded generator on the card.  A
             warm-up, the timed run with the counts set to 0 just before
             and read just after (every request DONE, one flash launch per
             layer per prefill and one paged launch per layer per decode
             step, meter exact), a second run token-identical with the drop
             log open (capacity drops per decode step and per prefill),
             peak memory at setup and serving
  moe_check  moe_apply at full width on each run's layer-0 weights for a
             decode batch of 8 rows and a 512-token prefill: per row
             within 2^-6 in relative norm of a float32 recomputation over
             the kept (token, expert) pairs (fp8 expert products, also
             computed, exceed it), a second call bit-identical, the
             router's top-k sets a float32 softmax's except at near-ties
             (gaps reported), and the W4A8 expert products (one kernel
             launch per expert on packed codes) bit-identical to the plain
             version
  reference_xattn  reduced llama-3.2-vision-11b (cross gates 0.7 and -0.9:
             the reference's zero gates would hide the cross path) and
             reduced seamless-m4t-medium on the card and on the CPU from
             the same weights and frontends: generate() fused and
             stepwise, with and without a stop token: identical tokens
  vision_path  llama-3.2-vision-11b at full width and depth (40 self
             layers, a gated cross block after every 5, 32/8 heads of 128,
             1,600 frontend tokens of 4,096; bf16 projections drawn per
             slice from a seeded generator on the card, every gate a
             seeded non-zero value): generate() on 4 prompts of 128 tokens
             with 4 frontends, 32 new, counts set to 0 just before and read
             just after (48 flash launches per prefill, 8 per decode step:
             the cross blocks at one query row; meter exact), a second call
             token-identical, stepwise generate() on 2 x 16 prompts (8 per
             step) token-identical to fused, forward on the prompts and the
             generated tokens (48 launches) whose argmax at each generated
             position is the decoded token or a near-tie, and another
             frontend moving the logits (a live cross path); rates, peaks,
             a profile of the decode steps
  encdec_path  seamless-m4t-medium at full width and depth (12 encoder
             and 12 decoder layers, 16/16 heads of 64, 960 frontend
             frames): generate() on 4 prompts of 64 tokens, 32 new (12
             flash launches per call: the encoder, once; the decode steps
             attend through the plain decode_attention, as in the
             reference), the same checks as vision_path, and forward on 2 x
             256 tokens (36 launches: encoder, causal self, cross)
  lm_forward the lm family's whole-sequence api.forward on serve_path's,
             gemma2_path's and both moe_path engines (1 x 128 tokens):
             one flash launch per layer (16, 46, 24, 8), finite logits, the
             last position's against the block prefill's (equal picks or a
             near-tie)
  profile    torch.profiler over 3 decode steps of each path
             (PROFILE_STEPS): device time by kernel and
             the device's busy share; on main_path the device kernels per
             W4A8 call (must be 1)
  times      CUDA-event times of each kernel at its path's shapes, replayed
             from a CUDA graph so the host's launch overhead is out (the
             eager time is kept beside it), with its bound, its plain
             version and a library yardstick (W4A8's bound at the packed
             half byte per code, and at one byte beside it); the paged
             kernel's outputs
             at each timed step's own geometry are first held against the
             plain version's; flash and paged also at gemma2-27b's shapes
             (a 4,084-token prefill's 46 launches, whose bound counts only
             the q-k pairs the window leaves visible, and a decode step's
             23 launches), where the library call is flex_attention
             compiled with the softcap as its score_mod (held against the
             plain version on the record) and SDPA without the softcap is
             timed beside it; and paged at llama2-7b's decode shape over
             an int8 and an fp8 pool (bound: 1-byte codes plus the live
             pages' scales; library: SDPA on the already dequantized
             gathered view), with features_path's launches; flash and
             paged at hymba-1.5b's shapes (a 2 x 2,048-token forward's 32
             launches with the 1024 window and group 5, whose library call
             is SDPA with a boolean window mask; a decode step's 32
             launches); flash and paged at both MoE shapes (phi3.5-moe's
             512-token prefill and decode step, 24 launches each;
             qwen3-moe's 256-token prefill and decode step, 8 launches
             each; SDPA with enable_gqa, and SDPA on the gathered view);
             and the expert FFN of one decode step at 8 slots (cuBLAS bf16
             bmm, not a kernel of the port) against reading every expert
             once; flash at the cross-attention shapes (the seamless
             encoder's 12 launches, the VLM's 8 cross launches in a
             prefill and in a decode step, non-causal; library: SDPA)

  train_kernels  the flash and scan kernels' autograd Functions at the
             training shapes (flash: B 8, 32/32 heads of 64, T 512, causal,
             bf16; scan: B 1, H 64, T 128, D 64): one launch, the forward
             the wrapper's output, every gradient the plain version's bit
             for bit; each of the four wrappers refuses an operand that
             requires grad in grad mode; the card's float32 sqrt correctly
             rounded; flash's time over a train step's 24 launches (bound,
             plain, SDPA) and the Functions' backward (the plain recompute)
  train_path (a) stablelm-1.6b at full width and depth through
             ``repro_torch.launch.train.main`` (24 steps of 8 x 512 tokens,
             float32 params, bf16 compute), counts set to 0 just before and
             read just after: 24 flash launches per step, the loss falls;
             ms per step, tokens/s, mfu, busy share over two profiled
             steps, peak memory.  (b) examples/train_e2e.py's kill-resume
             demonstration (granite-8b --smoke, batch 16, seq 128, lr 3e-3,
             a checkpoint every 20 steps, 300 steps): the first phase
             preempted after step 149, the restored state bit-identical to
             the saved one, the loss drop across the restart above 0.5, the
             gap to an uninterrupted run; an int8-moment save and restore

  dist_train_path  (a) granite-8b (arXiv:2405.04324) at full width and 3
             of its 36 layers (DIST), float32 params, bf16 compute, trained
             by a (2, 2) grid of four gloo ranks sharing the card
             (``runtime.spawn`` of ``make_train_step(grid=)``, FSDP over
             "data", Megatron's cuts over "model"), 4 steps of 8 x 512
             tokens, counts set to 0 just before and read just after: 3
             flash launches per rank per step and no other kernel, every
             rank's losses the same and its leaves cut as
             ``train_param_cuts`` says, step 1's loss within a relative 1e-3
             of ``api.loss_fn`` on the whole params in one process, the loss
             falls; ms per step, train tokens/s, per rank the seconds inside
             collectives, the busy share over two profiled steps and the
             peak memory, the peaks' sum.  (b) ``compressed_psum_mean`` of a
             4096 x 4096 float32 leaf over the "data" subgroups:
             bit-identical to a one-process replay, within 2 max|x| / 127
             of the exact mean.  (c) ``pipeline_apply`` over the four ranks
             (width 4096, 8 microbatches of 4, ``tanh(x @ W_s)``):
             bit-identical to the sequential application; its bubble
             fraction.  Then the flash kernel at a rank's shape (B 4, 16/4
             heads of 128, T 512, causal, bf16; bound, plain, SDPA) and the
             one-device step's first losses beside the grid's
  tp_train_grads  the flash and scan kernels' autograd Functions at every
             tp_train_path rank shape (TP_TRAIN_FLASH, TP_TRAIN_SCAN), as
             train_kernels holds them: one launch, the forward the
             wrapper's output, the gradients bit for bit
  tp_train_path  the families beyond the lm family's dense text configs:
             rwkv6-7b, hymba-1.5b, seamless-m4t-medium, llama-3.2-vision-11b
             and phi3.5-moe-42b-a6.6b (its experts cut over "model"), each
             at full width and a cut depth (TP_TRAIN), float32 params, bf16
             compute, remat "none", trained by a (1, 2) grid of two gloo
             ranks sharing the card (one ``runtime.spawn``), each released
             before the next: 3 steps with the counts set to 0 just before
             and read just after, the flash and scan launches a rank a step
             exactly as TP_TRAIN pins them (the scan at rwkv6-7b's 32 of 64
             heads) and no W4A8 or paged launch, every rank's losses the
             same and its leaves cut as ``train_param_cuts`` says, step 1's
             loss within a relative 1e-3 of ``api.loss_fn`` on the whole
             params in one process, step 1's grad norm and step 2's loss
             within ``DIST_ONE_DEVICE_RTOL`` of the one-device step's run
             here after the spawn (hymba's grad norm within its
             ``grad_rtol``, beside the one-device norm's own move under
             other roundings, ``tp_train_rounding_probe``), the MoE's aux
             the same and its drop log equal on both ranks; ms per step,
             per rank the seconds inside collectives, the busy share over
             one profiled step (its kernels) and the peak memory.  Then the kernels at the ranks' shapes (bound,
             plain, SDPA with a window mask for hymba)

  dryrun_path  the dry run (``launch/dryrun.py``) checked on the card:
             (a) stablelm-1.6b's train step at full depth, B 8 x T 512,
             remat none (train_path's shape), (b) its prefill
             (``api.forward``) at B 1 x T 4,096, (c) its decode step at B 8
             over a 4,096-position cache under ``--variant opt`` (LAQ
             W4A8 weights packed where they are built, the LSE decode
             body), (d) rwkv6-7b's prefill at 2 of its 32 layers, B 1 x T
             512: each traced on meta at grid (1, 1), then built from
             seeded weights on the card and run (a warm-up, then 3 timed
             runs, counts set to 0 just before each and read just after):
             every kernel's launches equal the trace's ``kernel_calls``
             exactly, the rank's argument bytes (params, state, cache,
             inputs) equal the trace's exactly, the card's temporaries
             (``max_memory_allocated`` over the step from a reset, minus
             what was allocated before the step) within DRYRUN_TEMP_RTOL
             of the trace's high-water mark, and, in a run of this phase
             alone, the raw peak within DRYRUN_PEAK_RTOL of the
             prediction (arguments + temporaries); the median step time
             is reported against the trace's ``t_bound`` and ``t_ideal``
             at the H100's peaks (reported, not checked); three full
             cells traced at (16, 16) one after another (granite-8b
             train_4k, gemma2-27b prefill_32k, qwen3-moe decode_32k at
             --variant opt; the host only), each with its report row and
             trace seconds;
             and the softcap probe: gemma2's ``logits /
             50`` on the card against the CPU over float32 logits across
             their range (a division by a Python number, which CUDA takes
             as a product by the reciprocal, reported) and
             ``ref._soft_cap`` (the divisor a 0-d tensor on the device:
             bit-identical, checked)

``python3 chip_smoke.py --only moe`` runs the device and build phases and
the MoE phases alone, and prints neither the kernels line nor the ok line;
``--only xattn`` does the same for the cross-attention phases (with the
flash phase's cases at their shapes); ``--only tp`` for tp_path (with the
w4a8, paged and flash phases' cases at its ranks' shapes; it then serves
its tp 1 tokens of (a) itself); ``--only train`` for train_kernels,
tp_train_grads, train_path, dist_train_path and tp_train_path (with the
flash phase's cases at the train step's and the grids' rank shapes, and
the rwkv phase's at tp_train_path's); ``--only dryrun`` for dryrun_path
(then the w4a8, flash and rwkv phases' cases at its shapes).

The line before the last two is ``{"kernels": [...]}``, then the
``nvidia-smi`` line, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.configs import get_config
from repro_torch.core.device import exact_matmuls
from repro_torch.core.quant import QuantizedLinear
from repro_torch.kernels import build, costs, ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.models import api
from repro_torch.serve import pages
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler, Request)
from repro_torch.serve.server import OnlineServer
from repro_torch.serve.splitbrain_engine import (
    SplitBrainEngine, traffic_model_for)
from repro_torch.train.optimizer import map_params
from torch_cases import (autograd_grads, bf16_ulp_of, feature_prompts,
                         load_example, pick_report, record_prefills,
                         replay_prefills, rwkv_decay_bits_report,
                         serve_staged, teacher_forced_logits)

SEED = 0
# the H100 SXM data sheet's dense peaks, and the kernels' work formulas,
# live in the package (kernels/costs.py), which the dry run reads too
HBM_BYTES_PER_S = costs.HBM_BYTES_PER_S
INT8_OPS_PER_S = costs.INT8_OPS_PER_S
F32_FLOPS_PER_S = costs.F32_FLOPS_PER_S
BF16_FLOPS_PER_S = costs.BF16_FLOPS_PER_S
W4A8_SRC = ("src/repro_torch/csrc/w4a8_matmul.cu",
            "src/repro/kernels/w4a8_matmul.py:30")
PAGED_SRC = ("src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:48")
FLASH_SRC = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:31")
RWKV_SRC = ("src/repro_torch/csrc/rwkv_scan.cu",
            "src/repro/kernels/rwkv_scan.py:25")
# For the reader only, printed on a labelled line of their own that no check
# reads and kept out of the kernels line: the two kernels redesigned last,
# at the times phases' units before that redesign, as PERF.md records them
# (CUDA-graph replay on an H100 80GB HBM3 at 700.00 W).  Not measured by
# this run.
BEFORE_REDESIGN = {"w4a8_decode_step_ms": 3.108,
                   "rwkv6_scan_forward_ms": 11.10}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (``elapsed_s``), so the log shows where the time limit goes."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phases
def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    # full-precision float matmuls on the card, as on the CPU: no TF32, and
    # no bf16 reduction inside cuBLAS's bf16 products (ServeEngine sets the
    # same for a CUDA device); reported as torch reads them back
    matmul = exact_matmuls()
    check(not any(matmul.values()), f"reduced-precision matmuls on: {matmul}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul": matmul}
    emit(info)
    return info


# one card test of each kernel, run under compute-sanitizer where it works
SANITIZER_TIMEOUT_S = 300
SANITIZED_TESTS = ("test_w4a8_kernel_bit_identical_to_plain[8-2048-256]",
                   "test_paged_kernel_split_and_lse_match_plain[bf16-opts2-0]",
                   "test_flash_kernel_matches_plain[bf16-1]",
                   "test_rwkv_kernel_matches_plain[bf16-0]")


def phase_sanitizer():
    """compute-sanitizer's memcheck and racecheck over one card test of
    each kernel, with the toolkit that builds the kernels.  The run fails
    unless the four tests pass under the tool with no error reported, or
    the tool refuses the device: its first message says "Device not
    supported" and no test passed (every CUDA call under it fails then).
    A timeout fails the run."""
    tool = Path(build.find_nvcc()).parent / "compute-sanitizer"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")
    rows, procs = {}, {}
    # both tools at once: each is a process of its own on the card
    for check_tool in ("memcheck", "racecheck"):
        if not tool.exists():
            rows[check_tool] = {"ran": False, "why": f"no {tool}"}
            continue
        cmd = [str(tool), "--tool", check_tool, "--error-exitcode", "86",
               sys.executable, "-m", "pytest", "--noconftest", "-q",
               "-p", "no:cacheprovider"] + [
               f"{ROOT / 'tests' / 'test_torch_gpu.py'}::{t}"
               for t in SANITIZED_TESTS]
        procs[check_tool] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
    deadline = time.monotonic() + SANITIZER_TIMEOUT_S
    try:
        for check_tool, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                check(False, f"compute-sanitizer {check_tool} timed out "
                             f"after {SANITIZER_TIMEOUT_S} s")
            res = subprocess.CompletedProcess(proc.args, proc.returncode,
                                              stdout, stderr)
            out = res.stdout + res.stderr
            tool_lines = [ln for ln in out.splitlines()
                          if ln.startswith("=========")]
            messages = [ln.strip("= ").strip() for ln in tool_lines]
            messages = [m for m in messages if m and m != "COMPUTE-SANITIZER"]
            passed = re.search(r"(\d+) passed", out)
            n_passed = int(passed.group(1)) if passed else 0
            unsupported = (bool(messages) and messages[0].startswith(
                "Error: Device not supported") and n_passed == 0)
            rows[check_tool] = {"ran": not unsupported,
                                "rc": res.returncode, "passed": n_passed,
                                "first_message": messages[:1],
                                "summary": [ln for ln in tool_lines
                                            if "SUMMARY" in ln]}
            check(unsupported or (res.returncode == 0
                                  and n_passed == len(SANITIZED_TESTS)),
                  f"compute-sanitizer {check_tool}: rc {res.returncode}, "
                  f"{n_passed} passed, {tool_lines[:20]}")
    finally:
        # a failed check leaves no tool running
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "sanitizer", "tests": SANITIZED_TESTS, "tools": rows})


KERNEL_NAME = re.compile(r"(w4a8_mma_kernel|paged_decode_kernel|"
                         r"flash_attention_tc_kernel|flash_attention_core_kernel|"
                         r"rwkv6_scan_kernel)I(.*?)EEv")


def short_name(mangled: str) -> str:
    m = KERNEL_NAME.search(mangled)
    return m.group(1) + "<" + m.group(2) + ">" if m else mangled


def sass_counts(lib_path: str,
                opcodes=("HMMA", "HGMMA", "IMMA", "FFMA", "FMUL", "FADD")):
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` of the built
    library, with the cuobjdump of the toolkit whose nvcc built it."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[:500]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m.group(1))
            counts[name] = {op: 0 for op in opcodes}
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def phase_build():
    info = build.build()
    build.library()
    kernels, name = [], None
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.append({"kernel": short_name(name),
                            "registers": int(m.group(1))})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernels and int(m.group(1)) + int(m.group(2)):
            kernels[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    spills = sum(k.get("spill_bytes", 0) for k in kernels)
    sass = sass_counts(info["path"])
    tc = {k: c for k, c in sass.items()
          if k.startswith("flash_attention_tc_kernel")}
    imma = {k: c["IMMA"] for k, c in sass.items() if k.startswith("w4a8_")}
    scan_ops = {k: {op: c[op] for op in ("FMUL", "FADD", "FFMA")}
                for k, c in sass.items() if k.startswith("rwkv6_scan_kernel")}
    redesigned = [dict(k, **sass.get(k["kernel"], {})) for k in kernels
                  if k["kernel"].startswith(("w4a8_", "rwkv6_scan_kernel"))]
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "cached": info["cached"], "sources": [p.name for p in build.sources()],
          "ptxas": kernels, "spill_bytes": spills,
          "redesigned": redesigned,
          "flash_tensor_core_mma": {k: c["HMMA"] + c["HGMMA"]
                                    for k, c in tc.items()},
          "w4a8_int8_mma": imma, "rwkv_scan_f32_ops": scan_ops,
          "note": "shared memory is dynamic (sized per launch); HMMA = "
                  "bf16 mma.sync, HGMMA = wgmma, IMMA = int8 mma.sync, "
                  "counted in cuobjdump -sass"})

    def count(prefix):
        return sum(k["kernel"].startswith(prefix) for k in kernels)
    check(count("flash_attention_tc_kernel") == 5,
          "ptxas report lacks the 5 tensor-core flash instantiations")
    check(count("flash_attention_core_kernel") == 4,
          "ptxas report lacks the 4 CUDA-core (f32) flash instantiations")
    check(count("paged_decode_kernel") == 18,
          "ptxas report lacks the 18 paged-decode instantiations")
    check(count("rwkv6_scan_kernel") == 6,
          "ptxas report lacks the 6 rwkv-scan instantiations")
    check(count("w4a8_mma_kernel") == 2,
          "ptxas report lacks the 2 W4A8 instantiations (bf16, f32 out)")
    check(len(imma) == 2 and all(n > 0 for n in imma.values()),
          f"a W4A8 instantiation runs no int8 tensor-core MMA: {imma}")
    check(len(tc) == 5 and all(c["HMMA"] + c["HGMMA"] > 0 for c in tc.values()),
          f"a bf16 flash instantiation runs no tensor-core MMA: {tc}")


W4A8_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
               (2048, 32000)]
W4A8_LLAMA2 = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# tp_path (a)'s column blocks on each of its two ranks: tinyllama's wq,
# wk / wv, w1 / w3 and head at (K, N / 2); wo and w2 stay whole
W4A8_TP = [(2048, 1024), (2048, 128), (2048, 2816), (2048, 16000)]
# dryrun_path (c)'s LAQ LM head: stablelm-1.6b's (d, vocab); its layers'
# shapes are W4A8_SHAPES'
W4A8_DRYRUN = [(2048, 100352)]


def w4a8_inputs(M, K, N, gen, dev):
    qx = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
    codes = torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
    ws = torch.rand((N,), generator=gen, device=dev) * 0.05 + 1e-3
    return qx, xs, codes, ws


def device_kernels(fn, attempts=3):
    """The names of the device kernels (and memsets) that one ``fn()``
    runs, from torch.profiler's device activity.  A profiler session early
    in a process can come back with no device activity at all (seen on an
    H100 with torch 2.11); such a session recorded nothing, so the call is
    profiled again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages() for _ in range(ev.count)
                 if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if names:
            break
    return names


def phase_w4a8(dev, shapes=None):
    """The W4A8 kernel against its plain version, bit for bit, at every
    (K, N) of ``shapes`` (default: every path's) with M 1 and 8."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if shapes is None:
        shapes = W4A8_SHAPES + W4A8_LLAMA2 + W4A8_TP + W4A8_DRYRUN
    cases = [(M, K, N) for (K, N) in shapes for M in (1, 8)]
    if shapes not in (W4A8_TP, W4A8_DRYRUN):
        cases += [(5, 2048, 1003), (3, 100, 37), (13, 5632, 130)]
        # examples_path (b): the serving example's batch of 4
        cases += [(4, K, N) for (K, N) in W4A8_LLAMA2]
    worst, per_call = 0.0, {}
    for M, K, N in cases:
        args = w4a8_inputs(M, K, N, gen, dev)
        packed = kw.pack_codes(args[2])
        for dt in (torch.bfloat16, torch.float32):
            out = ops.w4a8_matmul(*args, out_dtype=dt, packed=packed)
            plain = ref.w4a8_matmul(*args, dt)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            worst = max(worst, err)
            check(torch.equal(out, plain), f"W4A8 {M}x{K}x{N} {dt} differs "
                  f"from the plain version (max abs err {err})")
        if M == 8 and (K, N) in W4A8_SHAPES + W4A8_LLAMA2[:1]:
            names = device_kernels(
                lambda: ops.w4a8_matmul(*args, packed=packed))
            per_call[f"{K}x{N}"] = names
            check(len(names) == 1 and "w4a8" in names[0],
                  f"W4A8 {M}x{K}x{N}: one call ran {names}")
    emit({"phase": "w4a8", "cases": len(cases), "out_dtypes": ["bf16", "f32"],
          "tolerance": "bit-identical", "max_abs_err": worst,
          "plans": {f"{M}x{K}x{N}": kw.launch_plan(M, N, K, kw._sm_count(0))
                    ._asdict() for M, K, N in cases if M == 8},
          "device_kernels_per_call": per_call})
    return worst


def paged_inputs(gen, dev, *, B, Hq, Hkv, D, ps, P, lens, qdtype, kv=None):
    N = B * P + 1
    q = torch.randn((B, Hq, 1, D), generator=gen, device=dev).to(qdtype)
    kf = torch.randn((N, ps, Hkv, D), generator=gen, device=dev)
    vf = torch.randn((N, ps, Hkv, D), generator=gen, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:B * P] + 1
    table = perm.reshape(B, P).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    used = (lens_t[:, None] + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None, :] < used, table, 0)
    case = dict(q=q, table=table.contiguous(), lens=lens_t, k_scale=None,
                v_scale=None)
    if kv is None:
        case.update(k=kf.to(qdtype), v=vf.to(qdtype))
    else:
        e = torch.randint(-9, -5, (2, N, Hkv), generator=gen, device=dev)
        case.update(k_scale=torch.exp2(e[0].float()), v_scale=torch.exp2(e[1].float()))
        if kv == "int8":
            case.update(k=(kf * 40).round().clamp(-127, 127).to(torch.int8),
                        v=(vf * 40).round().clamp(-127, 127).to(torch.int8))
        else:
            case.update(k=(kf * 60).clamp(-440, 440).to(torch.float8_e4m3fn),
                        v=(vf * 60).clamp(-440, 440).to(torch.float8_e4m3fn))
    return case


def run_paged(case, fn, **kw):
    return fn(case["q"], case["k"], case["v"], case["table"], case["lens"],
              k_scale=case["k_scale"], v_scale=case["v_scale"], **kw)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0 ** -126)))
    return torch.exp2(e - 7)


def paged_error(case, out, **opts):
    """(max |out - plain|, max error in bf16 ulps or None, within the
    tolerance) of the kernel's output against the plain version's on the
    same case: for bf16 one bf16 ulp of the plain value plus the f32 bound
    of two sum orders (``ref.paged_decode_order_bound``, which matters only
    for outputs near zero), for f32 1e-5."""
    plain = run_paged(case, ref.paged_decode_attention, **opts)
    diff = (out.float() - plain.float()).abs()
    if out.dtype == torch.bfloat16:
        ulp = bf16_ulp(plain.float()) + 2.0 ** -133
        tol = ulp + run_paged(case, ref.paged_decode_order_bound, **opts)
        ulps, ok = (diff / ulp).max().item(), bool((diff <= tol).all())
    else:
        ulps, ok = None, bool((diff <= 1e-5).all())
    return diff.max().item(), ulps, ok


TINY = dict(B=8, Hq=32, Hkv=4, D=64, ps=16, P=16,
            lens=[0, 1, 15, 16, 17, 63, 130, 256])
LLAMA2 = dict(B=8, Hq=32, Hkv=32, D=128, ps=16, P=16,
              lens=[0, 3, 16, 40, 64, 100, 200, 255])
# the serve path's table (max_len 1024): split_plan's 16-page chunks
LLAMA2_SERVE = dict(LLAMA2, P=64, lens=[0, 1, 143, 208, 300, 431, 527, 1024])
# gemma2-27b's global layers on gemma2_path's table (4 slots, max_len 8192),
# at lengths that cross the local layers' 4096-token window
GEMMA2 = dict(B=4, Hq=32, Hkv=16, D=128, ps=16, P=512,
              lens=[0, 1000, 4096, 4117])
# tp_path's head-cut pools on each of its two ranks: (a) tinyllama's 16/2
# heads on main_path's table, (b) llama2-7b's 16/16 on its serve table,
# (d) qwen3-moe's 32/2 heads of 64 (group 16, run as slices of 8) on its
# table (max_len 512)
QWEN_TP = dict(B=8, Hq=32, Hkv=2, D=64, ps=16, P=32,
               lens=[0, 1, 31, 64, 100, 180, 257, 271])
PAGED_TP_CASES = [
    ("tinyllama tp 2 rank", dict(TINY, Hq=16, Hkv=2), torch.bfloat16, None,
     {}),
    ("llama2-7b serve tp 2 rank", dict(LLAMA2_SERVE, Hq=16, Hkv=16),
     torch.bfloat16, None, {}),
    ("qwen3-moe tp 2 rank", QWEN_TP, torch.bfloat16, None, {})]


def phase_paged(dev, cases=None):
    """The paged kernel against its plain version at every case (``cases``
    given: those alone)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf, f32 = torch.bfloat16, torch.float32
    every = [("tinyllama", TINY, bf, None, {}),
             ("tinyllama", TINY, bf, None, dict(window=40, softcap=30.0)),
             ("tinyllama", TINY, bf, "int8", {}),
             ("tinyllama", TINY, bf, "fp8", dict(softcap=30.0)),
             ("tinyllama", TINY, f32, "int8", dict(window=20)),
             ("llama2-7b", LLAMA2, bf, None, {}),
             ("llama2-7b", LLAMA2, f32, None, dict(window=50, softcap=20.0)),
             ("llama2-7b", LLAMA2, bf, "fp8", dict(window=7)),
             ("llama2-7b serve", LLAMA2_SERVE, bf, None, {}),
             ("llama2-7b serve", LLAMA2_SERVE, bf, None,
              dict(window=300, softcap=30.0)),
             ("gemma2-27b", GEMMA2, bf, None, dict(softcap=50.0)),
             ("gemma2-27b", GEMMA2, bf, None, dict(window=4096,
                                                   softcap=50.0)),
             ("gemma2-27b", GEMMA2, f32, None, dict(softcap=50.0))]
    cases = every + PAGED_TP_CASES if cases is None else cases
    worst, rows = 0.0, []
    for name, geom, qd, kv, opts in cases:
        case = paged_inputs(gen, dev, qdtype=qd, kv=kv, **geom)
        out, lse = run_paged(case, ops.paged_decode_attention,
                             return_lse=True, **opts)
        _, p_lse = run_paged(case, ref.paged_decode_attention,
                             return_lse=True, **opts)
        torch.cuda.synchronize()
        err, ulps, ok = paged_error(case, out, **opts)
        live = case["lens"] > 0
        lse_err = (lse[live] - p_lse[live]).abs().max().item()
        worst = max(worst, err)
        rows.append({"shape": name, "P": geom["P"],
                     "q": str(qd).split(".")[-1],
                     "pool": kv or str(qd).split(".")[-1], **opts,
                     "max_abs_err": err, "lse_max_abs_err": lse_err,
                     "max_err_bf16_ulps": ulps})
        check(ok, f"paged attention {rows[-1]} outside tolerance")
        check(not out[0].any().item(), "an empty slot must return zeros")
        check(lse_err <= 1e-5 and bool((lse[~live] <= -1e29).all()),
              f"paged attention LSE {rows[-1]} outside tolerance")
    emit({"phase": "paged", "cases": rows,
          "tolerance": "bf16: 1 bf16 ulp of the plain value + "
                       "ref.paged_decode_order_bound (8 * 2^-24 * "
                       "sum p|v| / l); f32: 1e-5; LSE: 1e-5 (live slots), "
                       "<= -1e29 (empty)",
          "max_abs_err": worst})
    return worst


def flash_inputs(gen, dev, B, Hq, Hkv, Tq, Tk, D, dtype):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


# the cross-attention families' flash shapes (B, Hq, Hkv, Tq, Tk, D):
# seamless-m4t-medium's encoder (non-causal over 960 frames, 16/16 heads of
# 64) and llama-3.2-vision-11b's cross blocks (32/8 heads of 128 over 1,600
# frontend tokens: a 127-row prompt body, a decode step's one row)
XATTN_FLASH_CASES = [
    ("seamless-m4t-medium encoder", (4, 16, 16, 960, 960, 64),
     dict(causal=False)),
    ("llama-3.2-vision-11b cross prefill", (4, 32, 8, 127, 1600, 128),
     dict(causal=False)),
    ("llama-3.2-vision-11b cross decode", (4, 32, 8, 1, 1600, 128),
     dict(causal=False))]
# tp_path's flash launches on each of its two ranks: (b)'s block prefill
# (llama2-7b's 16/16 heads of 128 over prompts of 64-256 tokens), (d)'s
# bucketed prefill (qwen3-moe's 32/2 heads of 64 at every bucket it
# reaches), (e)'s VLM prefill and cross blocks (16/4 heads of 128, a
# 63-row prompt body, 1,600 frontend tokens) and (f)'s seamless encoder
# (8/8 heads of 64 over 960 frames)
FLASH_TP_CASES = (
    [("llama2-7b tp 2 rank", (1, 16, 16, T, T, 128), dict(causal=True))
     for T in (100, 256)]
    + [("qwen3-moe tp 2 rank", (1, 32, 2, T, T, 64), dict(causal=True))
       for T in (1, 32, 64, 128, 256)]
    + [("llama-3.2-vision-11b tp 2 rank", (2, 16, 4, 63, 63, 128),
        dict(causal=True)),
       ("llama-3.2-vision-11b cross prefill tp 2 rank",
        (2, 16, 4, 63, 1600, 128), dict(causal=False)),
       ("llama-3.2-vision-11b cross decode tp 2 rank",
        (2, 16, 4, 1, 1600, 128), dict(causal=False)),
       ("seamless-m4t-medium encoder tp 2 rank", (4, 8, 8, 960, 960, 64),
        dict(causal=False))])


def phase_flash(dev, cases=None):
    """The flash kernel against its plain version at every case (``cases``
    given: those alone, as ``--only xattn`` runs the cross-attention
    families' shapes)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf, f32 = torch.bfloat16, torch.float32
    llama = [("llama2-7b", (1, 32, 32, T, T, 128), dict(causal=True))
             for T in (1, 37, 512)]
    other = [("tinyllama", (1, 32, 4, 300, 300, 64), dict(causal=True)),
             ("llama2-7b", (1, 32, 32, 64, 300, 128),
              dict(causal=False, kv_offset=236)),
             ("tinyllama", (1, 32, 4, 300, 300, 64),
              dict(causal=True, window=64, softcap=30.0)),
             # gemma2-27b's prefill: a 4,084-token prompt body on a local
             # layer, and 4,200 tokens, where the 4096-token window binds
             ("gemma2-27b", (1, 32, 16, 4084, 4084, 128),
              dict(causal=True, window=4096, softcap=50.0)),
             ("gemma2-27b", (1, 32, 16, 4200, 4200, 128),
              dict(causal=True, window=4096, softcap=50.0))]
    if cases is None:
        cases = (llama + other + XATTN_FLASH_CASES + FLASH_TP_CASES
                 + [TRAIN_FLASH_CASE, DIST_FLASH_CASE, DRYRUN_FLASH_CASE]
                 + tp_train_flash_cases())
    worst, rows = 0.0, []
    for name, shape, opts in cases:
        for qd in (bf, f32):
            q, k, v = flash_inputs(gen, dev, *shape, qd)
            out = ops.attention(q, k, v, **opts)
            plain = ref.flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()
            diff = (out.float() - plain.float()).abs()
            # bf16: one bf16 ulp of the plain value on top of the f32
            # tolerance -- an output near zero after cancellation has a
            # bf16 ulp below the f32 sum-order error of its 512 terms
            tol = (bf16_ulp(plain.float()) + 1e-5 if qd == bf
                   else torch.full_like(diff, 1e-5))
            err = diff.max().item()
            worst = max(worst, err)
            rows.append({"shape": name, "B_Hq_Hkv_Tq_Tk_D": shape,
                         "dtype": str(qd).split(".")[-1], **opts,
                         "body": kfa.body(qd, shape[-1]),
                         "max_abs_err": err})
            check(out.dtype == qd and out.shape == q.shape,
                  f"flash attention {rows[-1]}: dtype or shape")
            over = (diff - tol).flatten().argmax()
            check(bool((diff <= tol).all()), f"flash attention {rows[-1]} "
                  f"outside tolerance: kernel {out.flatten()[over].item()} "
                  f"vs plain {plain.flatten()[over].item()}")
    emit({"phase": "flash", "cases": rows,
          "tolerance": "bf16: 1 bf16 ulp of the plain value + 1e-5; "
                       "f32: 1e-5",
          "max_abs_err": worst})
    return worst


def rwkv_inputs(gen, dev, B, H, T, D, dtype, decay):
    """r, k, v standard normal and u (H, D) N(0, 1) * 0.3; decays w as
    rwkv6-7b's init makes them, exp(-exp(U(-8, -5))) (``"model"``), or
    U(0.8, 0.999) as the JAX kernel tests draw them (``"jax"``)."""
    r, k, v = (torch.randn((B, H, T, D), generator=gen, device=dev)
               for _ in range(3))
    w = torch.empty((B, H, T, D), device=dev)
    if decay == "model":
        w = torch.exp(-torch.exp(w.uniform_(-8.0, -5.0, generator=gen)))
    else:
        w.uniform_(0.8, 0.999, generator=gen)
    u = torch.randn((H, D), generator=gen, device=dev) * 0.3
    return [t.to(dtype) for t in (r, k, v, w)] + [u]


RWKV_FWD = (4, 64, 512, 64)        # rwkv6-7b's forward: B 4, H 64, T 512, D 64


def phase_rwkv(dev, cases=None):
    """The scan kernel against its plain version at every case (``cases``
    given: those alone)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf, f32 = torch.bfloat16, torch.float32
    B, H, _, D = RWKV_FWD
    if cases is None:
        cases = ([("rwkv6-7b forward", (B, H, T, D), bf, "model")
                  for T in (1, 37, 512)]
                 + [("jax kernel test", shape, f32, "jax")
                    for shape in ((2, 3, 64, 16), (1, 2, 128, 32),
                                  (1, 1, 32, 64))]
                 + [("rwkv6-7b, B 1", (1, H, 100, D), bf, "model")]
                 + [("B 1, odd H", shape, bf, "model")
                    for shape in ((1, 3, 37, 16), (1, 5, 512, 32))]
                 + [TP_TRAIN_SCAN_CASE, DRYRUN_SCAN_CASE])
    worst, rows = 0.0, []
    for name, shape, dt, decay in cases:
        r, k, v, w, u = rwkv_inputs(gen, dev, *shape, dt, decay)
        out, state = ops.rwkv6(r, k, v, w, u)
        p_out, p_state = ref.rwkv6_scan(r, k, v, w, u)
        torch.cuda.synchronize()
        diff = (out.float() - p_out.float()).abs()
        # bf16: one bf16 ulp of the plain value on top of the f32 sum-order
        # bound (the flash phase's rule, with its 1e-5 computed here)
        tol = (bf16_ulp(p_out.float())
               + ref.rwkv6_scan_order_bound(r, k, v, w, u).float()
               if dt == bf else torch.full_like(diff, 1e-4))
        s_err = (state - p_state).abs().max().item()
        err = diff.max().item()
        worst = max(worst, err, s_err)
        rows.append({"shape": name, "B_H_T_D": shape,
                     "dtype": str(dt).split(".")[-1], "decay": decay,
                     "max_abs_err": err, "state_max_abs_err": s_err,
                     "state_bit_identical": bool(torch.equal(state, p_state))})
        check(out.dtype == dt and out.shape == r.shape
              and state.shape == (shape[0], shape[1], shape[3], shape[3]),
              f"rwkv scan {rows[-1]}: dtype or shape")
        check(bool((diff <= tol).all()) and torch.equal(state, p_state),
              f"rwkv scan {rows[-1]} outside tolerance")
    emit({"phase": "rwkv", "cases": rows,
          "tolerance": "state: bit-identical; f32 out: 1e-4; bf16 out: 1 "
                       "bf16 ulp of "
                       "the plain value + 2 D 2^-24 sum_i |r_i (S_ij + u_i "
                       "k_i v_j)| (two f32 orders of the D-term sum)",
          "max_abs_err": worst})
    return worst


def reduced_requests(vocab):
    return [Request(uid=i, prompt=np.arange(1, 6 + 2 * i, dtype=np.int32) % vocab,
                    max_new=6) for i in range(5)]


def phase_reference(dev):
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    toks = {}
    for d in ("cpu", dev):
        eng = SplitBrainEngine(cfg, params, max_len=32, page_size=8, device=d)
        out = ContinuousBatchingScheduler(eng, max_slots=2).run(
            reduced_requests(cfg.vocab_size))
        toks[str(d)] = [r.tokens.tolist() for r in out["results"]]
    check(toks["cpu"] == toks[str(dev)],
          f"reduced tinyllama: card tokens {toks[str(dev)]} != CPU tokens "
          f"{toks['cpu']}")
    # generate(): prompt forcing and greedy decode on the dense cache, the
    # fused loop and the stepwise one, with a stop token one row emits
    prompts = np.stack([(np.arange(1, 7) * (5 + 2 * i) + i) % cfg.vocab_size
                        for i in range(3)]).astype(np.int32)
    gens = {}
    for fused in (True, False):
        eos = None
        for d in ("cpu", dev):
            eng = SplitBrainEngine(cfg, params, max_len=32, fused=fused,
                                   device=d)
            if eos is None:
                eos = int(eng.generate(prompts, max_new=8)["tokens"][1, 2])
            g = eng.generate(prompts, max_new=8, eos_id=eos)
            gens[(fused, str(d))] = (g["tokens"].tolist(),
                                     g["gen_len"].tolist())
        check(gens[(fused, "cpu")] == gens[(fused, str(dev))],
              f"reduced tinyllama generate(fused={fused}): card "
              f"{gens[(fused, str(dev))]} != CPU {gens[(fused, 'cpu')]}")
    emit({"phase": "reference", "config": cfg.name, "requests": len(toks["cpu"]),
          "generate": {"batch": 3, "prompt_len": 6, "max_new": 8,
                       "loops": ["fused", "stepwise"], "eos": True},
          "features": reference_features(dev, "splitbrain"),
          "tokens_identical_card_vs_cpu": True})


def phase_reference_serve(dev):
    """Reduced ServeEngine on the card (flash prefill, paged decode) and on
    the CPU (plain versions) from the same weights: identical tokens under
    the scheduler (paged pool) and generate()."""
    rows = []
    for arch in ("llama2-7b", "tinyllama-1.1b", "gemma2-27b",
                 "stablelm-1.6b", "granite-8b", "minitron-8b"):
        cfg = get_config(arch).reduced()
        params = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
        prompts = np.stack([(np.arange(1, 10) * (3 + i)) % cfg.vocab_size
                            for i in range(3)]).astype(np.int32)
        # past reduced gemma2's 16-token window: the per-token prefill
        long = np.stack([(np.arange(1, 25) * (5 + i)) % cfg.vocab_size
                         for i in range(2)]).astype(np.int32)
        toks = {}
        for d in ("cpu", dev):
            eng = ServeEngine(cfg, params, max_len=64, page_size=8, device=d)
            out = ContinuousBatchingScheduler(eng, max_slots=2).run(
                reduced_requests(cfg.vocab_size))
            gen = eng.generate(prompts, max_new=6)
            toks[str(d)] = ([r.tokens.tolist() for r in out["results"]],
                            gen["tokens"].tolist(),
                            eng.generate(long, max_new=6)["tokens"].tolist())
        check(toks["cpu"] == toks[str(dev)],
              f"reduced {arch} ServeEngine: card tokens {toks[str(dev)]} != "
              f"CPU tokens {toks['cpu']}")
        rows.append({"config": cfg.name, "requests": len(toks["cpu"][0]),
                     "generate_rows": len(toks["cpu"][1]) + len(long)})
    emit({"phase": "reference_serve", "configs": rows,
          "features": reference_features(dev, "serve"),
          "tokens_identical_card_vs_cpu": True})


# the KV-cache feature combinations held card against CPU at reduced size:
# (engine, arch, engine options, prefill chunk)
REFERENCE_FEATURES = [
    ("serve", "llama2-7b", dict(page_size=8, prefix_cache="on",
                                kv_dtype="int8"), 8),
    ("serve", "llama2-7b", dict(page_size=8, prefix_cache="on",
                                kv_dtype="fp8", paged_attn="gather"), 8),
    ("serve", "llama2-7b", dict(page_size=8, kv_dtype="fp8"), 8),
    ("serve", "llama2-7b", dict(page_size=8, kv_dtype="fp8"), None),
    ("serve", "llama2-7b", dict(page_size=8, kv_dtype="int8",
                                paged_attn="gather"), None),
    ("serve", "llama2-7b", dict(page_size=8, paged_attn="gather"), 8),
    ("serve", "llama2-7b", dict(), 8),
    ("serve", "gemma2-27b", dict(page_size=8, prefix_cache="on",
                                 kv_dtype="int8"), 8),
    ("splitbrain", "tinyllama-1.1b", dict(page_size=8, prefix_cache="on",
                                          kv_dtype="int8"), 8),
    ("splitbrain", "tinyllama-1.1b", dict(page_size=8, prefix_cache="on",
                                          kv_dtype="fp8",
                                          paged_attn="gather"), 8),
    ("splitbrain", "tinyllama-1.1b", dict(), 8),
]


def reference_features(dev, engine):
    """Each REFERENCE_FEATURES row of ``engine`` ("serve" or "splitbrain")
    served from the same weights on the card and on the CPU with
    ``torch_cases.feature_prompts`` (a shared two-page prefix: partial and
    whole-body hits, one copy-on-write copy), the first request alone until
    it decodes: identical tokens and cached tokens.

    A ServeEngine row with block prefill and an int8 / fp8 pool prefills
    through the flash kernel, which agrees with the plain version to one
    bf16 ulp, not bit for bit; the pool's coarse grid can turn that ulp
    into another code and a near-tie into another token.  There the CPU
    decodes from the card's prefilled request caches (``replay_prefills``)
    and must give the card's tokens, and whether its own prefill gives them
    too is reported.  Returns the rows."""
    rows = []
    for kind, arch, kw, chunk in REFERENCE_FEATURES:
        if kind != engine:
            continue
        cfg = get_config(arch).reduced()
        params = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
        flash_quant = (kind == "serve" and chunk is None
                       and kw.get("kv_dtype", "bf16") != "bf16")
        got, kept = {}, None
        for d in ((dev, "cpu", "cpu_own_prefill") if flash_quant
                  else ("cpu", dev)):
            eng = (ServeEngine(cfg, params, max_len=64,
                               device="cpu" if d == "cpu_own_prefill" else d,
                               **kw)
                   if kind == "serve" else
                   SplitBrainEngine(cfg, params, max_len=64, device=d, **kw))
            if flash_quant and d == dev:
                kept = record_prefills(eng)
            elif flash_quant and d == "cpu":
                replay_prefills(eng, kept)
            reqs = [Request(uid=i, prompt=p, max_new=6)
                    for i, p in enumerate(feature_prompts(cfg.vocab_size))]
            res = serve_staged([ContinuousBatchingScheduler(
                eng, max_slots=2, prefill_chunk=chunk)], [reqs])[0]
            check(all(r.state == "DONE" for r in res),
                  f"reduced {arch} {kw}: a request did not finish")
            got[str(d)] = ([r.tokens.tolist() for r in res],
                           [r.cached_tokens for r in res])
        check(got[str(dev)] == got["cpu"],
              f"reduced {arch} {kind} {kw} chunk {chunk}: card {got[str(dev)]}"
              f" != CPU {got['cpu']}")
        row = {"config": cfg.name, "engine": kind, **kw,
               "prefill_chunk": chunk, "cached_tokens": got["cpu"][1]}
        if flash_quant:
            own = got["cpu_own_prefill"][0]
            row["cpu_decodes_card_prefill"] = True
            row["requests_identical_with_cpu_prefill"] = sum(
                a == b for a, b in zip(own, got[str(dev)][0]))
        rows.append(row)
    return rows


RWKV_SEEDS = (0, 1, 2, 3)   # weight seeds of reduced rwkv6-7b, card vs CPU
RWKV_FWD_ULPS = 1           # forward logits: bf16 ulps of the largest |logit|
RWKV_SERVE_ULPS = 2         # the serve path's float32 decode logits


def phase_reference_rwkv(dev):
    """Reduced rwkv6-7b on the card (the scan kernel in forward) and on the
    CPU (plain versions) from the same weights, over RWKV_SEEDS.

    forward: logits within RWKV_FWD_ULPS bf16 ulps of the largest |logit|
    (the logits are rounded to bf16, and one changed rounding moves a logit
    by one ulp at its magnitude).  ServeEngine: the tokens the card chose
    under the scheduler and generate() are fed back, teacher-forced, through
    the serve path's decode steps on both devices; those float32 logits
    agree within RWKV_SERVE_ULPS ulps (the decays near 1 carry last-bit
    GEMM and exp differences along the sequence), and wherever the CPU
    would choose another token, the card's is a near-tie: its CPU logit
    falls short of the CPU's largest by at most twice the tolerance.  Exact
    cross-device token identity holds only where no such tie falls, so it
    is reported, not required."""
    cfg = get_config("rwkv6-7b").reduced()
    prompts = np.stack([(np.arange(1, 10) * (3 + i)) % cfg.vocab_size
                        for i in range(3)]).astype(np.int32)
    reqs = reduced_requests(cfg.vocab_size)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    rows = []
    for seed in RWKV_SEEDS:
        params = api.init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
        engs = {d: ServeEngine(cfg, params, max_len=64, device=d)
                for d in ("cpu", dev)}
        out = ContinuousBatchingScheduler(engs[dev], max_slots=2).run(reqs)
        gen = engs[dev].generate(prompts, max_new=6)
        check([r.state for r in out["results"]] == ["DONE"] * len(reqs)
              and all(len(r.tokens) == q.max_new
                      for q, r in zip(reqs, out["results"])),
              f"reduced rwkv6-7b seed {seed}: a request did not finish")
        seqs = ([(q.prompt, r.tokens) for q, r in zip(reqs, out["results"])]
                + [(p, t) for p, t in zip(prompts, gen["tokens"])])
        tf = {d: torch.cat([teacher_forced_logits(engs[d].params, cfg, p, t, d)
                            for p, t in seqs]) for d in engs}
        picks = np.concatenate([t for _, t in seqs])
        serve = pick_report(tf["cpu"], tf[dev], picks)
        fwd = {d: api.forward(engs[d].params, toks.to(d), cfg)[0]
               .reshape(-1, cfg.vocab_size).cpu() for d in engs}
        fwd_rep = pick_report(fwd["cpu"], fwd[dev], fwd[dev].argmax(-1))
        for name, rep, ulps in (("forward", fwd_rep, RWKV_FWD_ULPS),
                                ("serve", serve, RWKV_SERVE_ULPS)):
            rep["tolerance"] = ulps * bf16_ulp_of(rep["max_abs_logit"])
            check(rep["max_abs_err"] <= rep["tolerance"]
                  and rep["shortfall"] <= 2 * rep["tolerance"],
                  f"reduced rwkv6-7b seed {seed} {name}: card vs CPU {rep}")
        rows.append({"seed": seed, "forward": fwd_rep, "serve": serve})
    # which ops of the decay path differ between the card and the CPU on
    # the same inputs (layer 0 of the last seed's serving weights)
    from repro_torch.models import rwkv6
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(SEED + 1)).to(torch.bfloat16)
    bits = rwkv_decay_bits_report(next(rwkv6._layers(engs["cpu"].params))[1],
                                  x, dev)
    check(bits["decay"]["differ"] == 0,
          f"rwkv6.decay differs between the card and the CPU: {bits}")
    emit({"phase": "reference_rwkv", "config": cfg.name,
          "decay_path_ops_card_vs_cpu": bits,
          "requests": len(reqs), "generate_rows": len(prompts),
          "forward_tokens": list(toks.shape),
          "tolerance": f"forward: {RWKV_FWD_ULPS} bf16 ulp of the largest "
                       f"|logit|; serve, teacher-forced: {RWKV_SERVE_ULPS}; "
                       "a pick the CPU would not make falls short of the "
                       "CPU's largest logit by at most twice the tolerance",
          "seeds": rows})


def main_requests(vocab, n=16, max_new=32):
    rng = np.random.default_rng(SEED)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(8, 65)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


class PhaseClock:
    """Host seconds spent in the engine's decode steps and admissions
    (prefill, prefill chunks, the prefix seed and the insert; the insert's
    length read waits for the prefill), and the calls of each
    (``calls``).  ``detach()`` gives the engine its own methods back."""

    ADMIT = ("prefill_slot", "insert_slot", "prefill_chunk_slot",
             "seed_request_cache")

    def __init__(self, eng):
        self.eng = eng
        self.reset()
        for name in ("decode_slots",) + self.ADMIT:
            setattr(eng, name, self._timed(getattr(eng, name), name))

    def _timed(self, fn, name):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            if name == "decode_slots":
                self.decode_s += dt
            else:
                self.admit_s += dt
            self.calls[name] += 1
            return out
        return call

    def reset(self):
        self.decode_s = self.admit_s = 0.0
        self.calls = {name: 0 for name in ("decode_slots",) + self.ADMIT}

    @classmethod
    def detach(cls, eng):
        """Give ``eng`` its own methods back (any clock's)."""
        for name in ("decode_slots",) + cls.ADMIT:
            eng.__dict__.pop(name, None)


# the main path's tinyllama-1.1b at full width and MAIN_LAYERS of its 22
# layers, to keep the script inside its time limit: its engine also carries
# features_splitbrain, chaos_path (a) and tp_path (a), whose split-brain
# prompt-token steps cost host time per layer (at 11 layers, a host 1.3x
# slower on the host-bound phases took 1,299 s to reach the end of
# dist_train_path; at 6 the whole script took 797.5 s on one H100 host; 8
# kept such a slow host under the limit until tp_train_path came, and 6
# pays for it: ROADMAP.md)
MAIN_LAYERS = 6


def main_cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b"),
                               num_layers=MAIN_LAYERS)


def phase_main_path(dev, smi_line):
    cfg = main_cfg()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = SplitBrainEngine(cfg, params, max_len=256, page_size=16,
                           quantize=True, device=dev)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mats = [w for p in eng._layers for part in ("attn", "mlp")
            for w in p[part].values()] + [eng._head]
    check(all(w.packed is not None and w.packed.is_cuda for w in mats),
          "a quantized matrix lacks its packed codes on the card")
    weight_bytes = {"codes_int8": sum(w.codes.numel() for w in mats),
                    "packed": sum(w.packed.numel() for w in mats)}
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=8, max_new=4)
    reqs = main_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    L = cfg.num_layers
    want = {"w4a8_matmul": (7 * L + 1) * (prefill + steps),
            "paged_decode_attention": L * steps, "flash_attention": 0,
            "rwkv6_scan": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.meter.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    # generate(): 4 prompts of 64 tokens forced through the token step on
    # the dense cache, then 32 greedy tokens; every projection a W4A8 launch
    prompts = np.random.default_rng(SEED + 12).integers(
        1, cfg.vocab_size, (4, 64)).astype(np.int32)
    ops.reset_launch_counts()
    g = eng.generate(prompts, max_new=32)
    gen_counts = ops.launch_counts()
    token_steps = 63 + 32
    check(gen_counts == {"w4a8_matmul": (7 * L + 1) * token_steps,
                         "paged_decode_attention": 0, "flash_attention": 0,
                         "rwkv6_scan": 0},
          f"generate() launch counts {gen_counts}: not {7 * L + 1} W4A8 per "
          f"token step over {token_steps} steps")
    check(g["tokens"].shape == (4, 32) and g["gen_len"].tolist() == [32] * 4
          and bool(((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()),
          "generate() tokens out of range or short")
    info = {"phase": "main_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "max_slots": 8, "page_size": 16,
            "max_len": 256, "requests": len(reqs), "all_done": True,
            "setup_s": round(setup_s, 3), "prefill_tokens": prefill,
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "launches_expected": want,
            "meter_bytes": meter, "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "peak_memory_bytes": peak, "weight_bytes": weight_bytes,
            "generate": {"batch": 4, "prompt_len": 64, "max_new": 32,
                         "token_steps": token_steps, "launches": gen_counts,
                         "w4a8_per_token_step":
                             gen_counts["w4a8_matmul"] / token_steps,
                         "seconds": g["decode_s"],
                         "tokens_per_s": g["tokens_per_s"]},
            "card": smi_line}
    emit(info)
    info["_tokens"] = first          # the fault-free tokens, for chaos_path
    return eng, info


# ------------------------------------------------------------ examples_path
EXAMPLES_TOKENS = 8                  # the quickstart's decode_token steps
EXAMPLES_SERVE = dict(arch="llama2-7b", layers=4, batch=4, prompt=5, new=12)


def examples_quickstart(dev, qs):
    """(a): the quickstart's ``run()`` on the card and on the CPU from the
    same seeded weights of main_path's tinyllama."""
    cfg = main_cfg()
    L = cfg.num_layers
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = qs.run(cfg, params, device=dev, n_tokens=EXAMPLES_TOKENS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {"w4a8_matmul": (7 * L + 1) * EXAMPLES_TOKENS,
            "paged_decode_attention": 0, "flash_attention": 0,
            "rwkv6_scan": 0}
    check(counts == want, f"examples_path (a) launches {counts} != {want}")
    t0 = time.perf_counter()
    params = map_params(lambda t: t.cpu(), params)
    cpu = qs.run(cfg, params, device="cpu", n_tokens=EXAMPLES_TOKENS)
    cpu_s = time.perf_counter() - t0
    del params
    check(card["codes"].is_cuda and torch.equal(card["codes"].cpu(),
                                                cpu["codes"]),
          "examples_path (a): the wq codes made on the card differ from "
          "the CPU's")
    check(card["report"] == cpu["report"] and card["pruned"] == cpu["pruned"],
          "examples_path (a): the report differs from the CPU's")
    bpt = traffic_model_for(cfg).bytes_per_token()
    check(card["measured_bytes_per_token"] == card["model_bytes_per_token"]
          == bpt, f"examples_path (a): meter {card['measured_bytes_per_token']}"
          f" B/token != eq. 7-10's {bpt}")
    toks, cpu_toks = card["tokens"], cpu["tokens"]
    check(all(0 <= t < cfg.vocab_size for t in toks), "token out of range")
    # the first step where the picks part: the inputs up to it were the
    # same on both devices, so the CPU's logits there judge the card's pick
    n = next((i for i, (a, b) in enumerate(zip(toks, cpu_toks)) if a != b),
             None)
    upto = len(toks) if n is None else n + 1
    rep = pick_report(cpu["logits"][:upto], card["logits"][:upto],
                      toks[:upto])
    check(n is None or rep["shortfall"] <= 2 * rep["max_abs_err"],
          f"examples_path (a): the card's token {n} is not the CPU's and "
          f"not a near-tie: {rep}")
    rpt = card["report"]
    return {"config": cfg.name, "layers": L, "d_model": cfg.d_model,
            "tokens": toks, "tokens_identical_to_cpu": n is None,
            "first_divergence": n, "pick_report": rep,
            "launches": counts, "w4a8_per_token_step":
                counts["w4a8_matmul"] / EXAMPLES_TOKENS,
            "codes_equal_cpu": True, "wq_codes": card["codes"].numel(),
            "pruned": card["pruned"], "report_equal_cpu": True,
            "meter_bytes_per_token": card["measured_bytes_per_token"],
            "model_bytes_per_token": bpt,
            "report": {"arch": rpt["arch"],
                       "ita_gates": rpt["gates"]["ita_gates"],
                       "reduction_x": rpt["gates"]["reduction_x"],
                       "ita_pj": rpt["energy"]["ita"]["total_pj"],
                       "energy_x": rpt["energy"]["improvement_vs_int8"]["x"],
                       "die_mm2": rpt["area"]["final_mm2"],
                       "unit_cost": rpt["cost"]["unit_cost"]},
            "card_s": card_s, "cpu_s": cpu_s}


def examples_serve(dev, sv):
    """(b): the serving example's ``run()`` at llama2-7b's full width."""
    spec = EXAMPLES_SERVE
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["layers"])
    L = cfg.num_layers
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (spec["batch"], spec["prompt"])).astype(np.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = sv.run(cfg, params, prompts, device=dev, max_new=spec["new"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    del params
    steps = spec["prompt"] - 1 + spec["new"]
    per_step = 7 * L + 1
    parts = r["launches"]
    check(not any(v for p in ("float_warmup", "float_fused", "float_stepwise")
                  for v in parts[p].values()),
          f"examples_path (b): a float run launched a kernel: {parts}")
    want = {"w4a8_matmul": per_step * steps, "paged_decode_attention": 0,
            "flash_attention": 0, "rwkv6_scan": 0}
    check(parts["w4a8"] == want,
          f"examples_path (b): LAQ generate() launches {parts['w4a8']} != "
          f"{want}")
    check(parts["w4a8_decode_token"]["w4a8_matmul"] == per_step
          and sum(parts["w4a8_decode_token"].values()) == per_step,
          f"examples_path (b): decode_token launches "
          f"{parts['w4a8_decode_token']}")
    check(sum(counts.values()) == sum(sum(p.values()) for p in parts.values()),
          f"examples_path (b): launches outside the parts: {counts}")
    bpt = traffic_model_for(cfg).bytes_per_token()
    check(r["measured_bytes_per_token"] == r["model_bytes_per_token"] == bpt,
          f"examples_path (b): meter {r['measured_bytes_per_token']} B/token "
          f"at batch {spec['batch']} != eq. 7-10's {bpt}")
    for name, toks in r["tokens"].items():
        check(toks.shape == (spec["batch"], spec["new"])
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"examples_path (b): {name} tokens out of range or short")
    return {"config": cfg.name, "layers": L, "d_model": cfg.d_model,
            "batch": spec["batch"], "prompt_len": spec["prompt"],
            "max_new": spec["new"], "token_steps": steps,
            "launches": counts, "launches_by_part": parts,
            "w4a8_per_token_step": parts["w4a8"]["w4a8_matmul"] / steps,
            "meter_bytes_per_token": r["measured_bytes_per_token"],
            "model_bytes_per_token": bpt,
            "fused_stepwise_agreement": r["fused_stepwise_agreement"],
            "float_w4a8_agreement": r["float_w4a8_agreement"],
            "tokens_per_s": {k: r[k]["tokens_per_s"] for k in (
                "float_fused", "float_stepwise", "w4a8")},
            "seconds": seconds}


def phase_examples_path(dev, smi_line):
    t0 = time.perf_counter()
    qs = load_example("quickstart_torch")
    sv = load_example("serve_splitbrain_torch")
    a = examples_quickstart(dev, qs)
    gc.collect()
    torch.cuda.empty_cache()
    b = examples_serve(dev, sv)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    info = {"phase": "examples_path", "quickstart": a, "serve_splitbrain": b,
            "launches": launches, "seconds": time.perf_counter() - t0,
            "card": smi_line}
    emit(info)
    return info


def serve_requests(vocab, n=16, max_new=32):
    rng = np.random.default_rng(SEED + 4)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(64, 513)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


# serve_path's llama2-7b (reused by features_path, chaos_path (b)-(d) and
# lm_forward) runs 16 of its 32 layers at full width since the
# cross-attention paths joined, to keep the script inside its time limit:
# its host-bound steps grow with the depth; the times rows keep the
# 32-layer units
SERVE_LAYERS = 16


def phase_serve_path(dev, smi_line):
    """Full-width llama2-7b at SERVE_LAYERS of its 32 layers through the
    float ServeEngine: the scheduler over a paged pool, then generate()."""
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              num_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = ServeEngine(cfg, params, max_len=1024, page_size=16, device=dev)
    del params                      # the f32 tree: the engine keeps bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=64, max_new=4)
    reqs = serve_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    L = cfg.num_layers
    want = {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
            "paged_decode_attention": L * steps, "rwkv6_scan": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    # generate(): one block prefill of 4 x 127 tokens, then 16 lockstep steps
    rng = np.random.default_rng(SEED + 5)
    prompts = rng.integers(1, cfg.vocab_size, (4, 128)).astype(np.int32)
    ops.reset_launch_counts()
    g1 = eng.generate(prompts, max_new=16)
    gen_counts = ops.launch_counts()
    g2 = eng.generate(prompts, max_new=16)
    check(gen_counts == {"w4a8_matmul": 0, "flash_attention": L,
                         "paged_decode_attention": 0, "rwkv6_scan": 0},
          f"generate() launch counts {gen_counts}")
    check(np.array_equal(g1["tokens"], g2["tokens"])
          and g1["tokens"].shape == (4, 16)
          and bool(((g1["tokens"] >= 0) & (g1["tokens"] < cfg.vocab_size)).all()),
          "generate() tokens out of range or not repeatable")
    info = {"phase": "serve_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "dtype": cfg.dtype,
            "max_slots": 8, "page_size": 16, "max_len": 1024,
            "num_pages": eng._pager.pool.num_pages,
            "requests": len(reqs), "all_done": True,
            "setup_s": setup_s, "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "launches_expected": want,
            "meter_bytes": meter, "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "generate": {"batch": 4, "prompt_len": 128, "max_new": 16,
                         "launches": gen_counts, "repeatable": True,
                         "prefill_s": g1["prefill_s"],
                         "decode_s": g1["decode_s"],
                         "decode_tokens_per_s": g1["tokens_per_s"]},
            "peak_memory_bytes": peak, "setup_peak_memory_bytes": setup_peak,
            "card": smi_line}
    emit(info)
    return eng, info


# ----------------------------------------------------------------- tp_path
# Two ranks of a torch.distributed group share the one card over gloo (NCCL
# refuses two ranks on one device), each a process of its own running the
# same engine over its shard: (a) the main path's split-brain tinyllama,
# (b) the float llama2-7b at TP_LAYERS of its 32 layers, (c) the paged
# kernel's TP dispatch at the card's shapes.
TP = 2
TP_LAYERS = 8
# (c): the page-split LSE merge (one KV head, whole on every rank) and the
# head cut (32/8 heads, 4 KV heads a rank) on the serve path's table
TP_MERGE = dict(B=8, Hq=32, Hkv=1, D=128, ps=16, P=64,
                lens=[0, 1, 100, 255, 256, 517, 900, 1024])
TP_HEADS = dict(TP_MERGE, Hkv=8)


def tp_serve_requests(vocab, n=8, max_new=16):
    rng = np.random.default_rng(SEED + 21)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(64, 257)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


def tp_rank_profile(eng, slots=8, n=None):
    """This rank's device time over ``n`` (PROFILE_STEPS) decode steps with
    every slot decoding (prompts of 2 tokens, so that admission is one
    token step each), and its busy share of the rank's wall time: its share
    of the card."""
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_STEPS if n is None else n
    sched = ContinuousBatchingScheduler(eng, max_slots=slots)
    sched.begin()
    for r in main_requests(eng.cfg.vocab_size, n=slots, max_new=n + 6):
        sched.submit(Request(uid=r.uid, prompt=r.prompt[:2],
                             max_new=r.max_new))
    while len(sched.decoding_uids()) < slots:
        sched.step()
    for _ in range(2):
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while sched.has_work():
        sched.step()
    s = profile_summary(prof, wall, n, "tp_path")
    return {k: s[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                              "device_busy_share", "host_ops_per_step")}


def tp_rank_serve(eng, reqs, warm_len):
    """A warm-up run, then ``reqs`` under the scheduler with 8 slots, the
    counts set to 0 just before and read just after.  Returns the run's
    figures, its tokens by uid and its slot cache's stats."""
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=warm_len, max_new=4)
    clock.reset()
    torch.cuda.synchronize()
    eng.meter.reset()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    PhaseClock.detach(eng)
    res = sorted(out["results"], key=lambda r: r.uid)
    max_new = {r.uid: r.max_new for r in reqs}
    check(all(r.state == "DONE" and r.gen_len == max_new[r.uid]
              for r in res),
          f"tp_path: not every request DONE in full: {out['by_state']}")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "tp_path: the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    tokens = prefill + out["decoded_tokens"]
    meter = eng.meter.measured_bytes()["total"]
    check(meter == traffic_model_for(eng.cfg).bytes_per_token() * tokens,
          f"tp_path: meter {meter} != eq. 7-10 x {tokens} tokens")
    return {"requests": len(reqs), "prefill_tokens": prefill,
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "meter_bytes": meter,
            "meter_bytes_per_token": meter / tokens,
            "traffic_shards": eng.traffic_shards,
            "kv_shards": eng.cache_stats(sched.cache)["kv_shards"],
            "cache_bytes": eng.cache_stats(sched.cache)["cache_bytes"],
            "wall_s": out["wall_s"], "decode_s": clock.decode_s,
            "admit_s": clock.admit_s,
            "decode_steps_per_s": steps / clock.decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / clock.decode_s,
            }, [r.tokens.tolist() for r in res]


def tp_paged_bound_ms(geom, hkv):
    """The least time of one paged launch over ``hkv`` KV heads of
    ``geom``'s bf16 pool: each live K and V row read once, q read and out
    written once, at the HBM rate."""
    rows = sum(geom["lens"])
    q_heads = geom["Hq"] * hkv // geom["Hkv"]
    nbytes, _ = costs.paged(geom["B"], q_heads, hkv, geom["D"], rows)
    return nbytes / HBM_BYTES_PER_S * 1e3


def tp_rank_paged(group, dev):
    """(c) on this rank: the merge (ops' TP dispatch over the whole pool)
    and the head cut (the rank's 16 query and 4 KV heads) against the
    unsharded kernel and the plain version, on the same seeded inputs on
    both ranks.  Launches here are comparisons and are not counted."""
    from repro_torch.distributed import sharding
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    out = {}
    mcase = paged_inputs(gen, dev, qdtype=torch.bfloat16, **TP_MERGE)
    merged = run_paged(mcase, ops.paged_decode_attention, tp=group)
    whole = run_paged(mcase, kpa.paged_decode_attention)
    torch.cuda.synchronize()
    err, ulps, ok = paged_error(mcase, merged)
    check(ok, f"tp_path (c): the merge is outside phase_paged's bf16 bound "
              f"(max error {err}, {ulps} ulps)")
    out["merge"] = {"max_abs_err_vs_plain": err, "max_err_bf16_ulps": ulps,
                    "max_abs_diff_vs_unsharded_kernel":
                        (merged.float() - whole.float()).abs().max().item(),
                    "empty_slot_zero": not merged[0].any().item()}
    case = paged_inputs(gen, dev, qdtype=torch.bfloat16, **TP_HEADS)
    whole = run_paged(case, kpa.paged_decode_attention)
    q = sharding.shard(case["q"], 1, group)
    k, v = (sharding.shard(case[n], 2, group) for n in ("k", "v"))
    cut = ops.paged_decode_attention(q, k, v, case["table"], case["lens"],
                                     tp=group, head_cut=True)
    own = kpa.paged_decode_attention(q, k, v, case["table"], case["lens"])
    mine = sharding.shard(whole, 1, group)
    torch.cuda.synchronize()
    check(torch.equal(cut, mine), "tp_path (c): the head-cut kernel is not "
          "bit-identical to the unsharded kernel's heads")
    # the rank's heads against the plain version on the rank's inputs
    cut_err, cut_ulps, ok = paged_error(dict(case, q=q, k=k, v=v), cut)
    check(ok, f"tp_path (c): the head cut is outside phase_paged's bf16 "
              f"bound (max error {cut_err}, {cut_ulps} ulps)")
    plan = kpa.split_plan(TP_HEADS["ps"], TP_HEADS["P"],
                          TP_HEADS["B"] * TP_HEADS["Hkv"], TP_HEADS["D"])
    args = (q, k, v, case["table"], case["lens"])
    whole_args = (case["q"], case["k"], case["v"], case["table"],
                  case["lens"])
    group.barrier()
    out["head_cut"] = {
        "bit_identical_to_unsharded": True,
        "max_abs_err_vs_plain": cut_err, "max_err_bf16_ulps": cut_ulps,
        "own_plan_max_abs_diff":
            (own.float() - mine.float()).abs().max().item(),
        "plan": list(plan),
        "own_plan": list(kpa.split_plan(TP_HEADS["ps"], TP_HEADS["P"],
                                        TP_HEADS["B"] * k.shape[2],
                                        TP_HEADS["D"])),
        # CUDA-event times per launch; both ranks time at once, so each
        # shares the card with the other rank's launches
        "rank_kernel_ms": cuda_time_ms(
            lambda: kpa.paged_decode_attention(*args, plan=plan), 50),
        "unsharded_kernel_ms": cuda_time_ms(
            lambda: kpa.paged_decode_attention(*whole_args), 50),
        # the K/V rows the lengths need, q and out, once: bytes-bound
        "rank_bound_ms": tp_paged_bound_ms(TP_HEADS, k.shape[2]),
        "unsharded_bound_ms": tp_paged_bound_ms(TP_HEADS, TP_HEADS["Hkv"])}
    # the library call: SDPA (enable_gqa) on the already-gathered dense
    # view of the rank's heads and of every head, as the other paged rows
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, view in (("rank_library_ms", dense_view(dict(case, q=q, k=k,
                                                          v=v))),
                      ("unsharded_library_ms", dense_view(case))):
        out["head_cut"][key] = cuda_time_ms(
            lambda: sdpa(view[0], view[1], view[2], attn_mask=view[3],
                         enable_gqa=True), 50)
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        run_paged(mcase, ops.paged_decode_attention, tp=group)
    torch.cuda.synchronize()
    out["merge"]["wall_ms_per_call"] = (time.perf_counter() - t0) / 20 * 1e3
    return out


# (d)-(g): the rest of the registry and of the entry points on the ranks.
# (d) qwen3-moe-235b-a22b at full width and TP_MOE["layers"] of its 94
# layers (every rank holds every expert: the column-only serve cut leaves
# the expert stacks whole, 4.83 GB of bf16 a layer), moe_path (b)'s 8
# requests; (e) llama-3.2-vision-11b at full width and 10 of its 40 layers
# (two gated cross blocks, seeded gates); (f) seamless-m4t-medium at full
# width, its 12 encoder layers and 6 of its 12 decoder layers (its
# per-token prefill takes ~37 gloo gathers a step at full depth: 27.7 s of
# a rank's time, over the new parts' budget; ROADMAP.md's ground rules);
# (g) split-brain generate() on (a)'s engine and the
# online layer under a seeded chaos plan on (b)'s, rank 1 sleeping
# TP_ONLINE["sleep_s"] an iteration so that its own clock runs apart.
TP_MOE = dict(arch="qwen3-moe-235b-a22b", layers=4, max_len=512, requests=8,
              prompt=(32, 256), new=16, seed=SEED + 31)   # moe_path (b)'s
TP_VISION = dict(arch="llama-3.2-vision-11b", layers=10, fused=(2, 64, 16),
                 step=(2, 16, 8), seed=SEED + 40)
TP_ENCDEC = dict(arch="seamless-m4t-medium", layers=6, fused=(4, 64, 16),
                 seed=SEED + 41)
TP_SB_GEN = (4, 16, 8)              # split-brain generate(): B, T0, new
TP_ONLINE = dict(plan=dict(step_corrupt_at=4, step_corrupt_iters=2,
                           device_loss_at=10),
                 requests=4, new=8, sleep_s=0.004)


# (h) the sequence-cut dense decode (parallel.decode_attn="shard_map"):
# llama2-7b at (b)'s depth on a dense slot cache of 1,024 positions, a rank
# holding every KV head of its 512; (i) the OnlineServer on (a)'s engine:
# six requests from a client thread on rank 0, streamed (one the client
# cancels after two tokens, one past its deadline, one whose consumer
# callback raises at its second token, one of a higher priority), a decode
# step stalled 4.5 s at iteration 3 tripping a 3 s watchdog once (a stall
# of two windows or more would trip it again; the window is more than an
# iteration's two re-prefills after the recovery take on a rank, about
# 1.2 s: a shorter one tripped again at every iteration, each recovery
# requeueing longer prefills)
TP_SEQ = dict(max_len=1024, requests=8, prompt=(64, 513), new=16,
              seed=SEED + 51)
TP_SERVER = dict(slots=2, stall_at=3, stall_s=4.5, watchdog_s=3.0, new=8,
                 seed=SEED + 52)


def tp_seq_engine(dev, tp=None):
    """(h)'s engine: llama2-7b at TP_LAYERS layers, full width, seeded bf16
    weights, the knob on, the dense slot cache of TP_SEQ["max_len"]."""
    cfg = dataclasses.replace(get_config("llama2-7b"), num_layers=TP_LAYERS)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, decode_attn="shard_map"))
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, max_len=TP_SEQ["max_len"], device=dev,
                      tp=tp)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return eng


def tp_seq_requests(vocab):
    rng = np.random.default_rng(TP_SEQ["seed"])
    lo, hi = TP_SEQ["prompt"]
    return [Request(uid=i, prompt=rng.integers(1, vocab, int(
        rng.integers(lo, hi))).astype(np.int32), max_new=TP_SEQ["new"])
        for i in range(TP_SEQ["requests"])]


def tp_seq_run(eng):
    """(h)'s requests under the scheduler with 8 slots after a warm-up, the
    counts set to 0 just before and read just after: the run's figures and
    its tokens by uid."""
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    sched.warmup(prompt_len=64, max_new=4)
    clock = PhaseClock(eng)
    reqs = tp_seq_requests(eng.cfg.vocab_size)
    torch.cuda.synchronize()
    eng.meter.reset()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    PhaseClock.detach(eng)
    res = sorted(out["results"], key=lambda r: r.uid)
    check(all(r.state == "DONE" and r.gen_len == TP_SEQ["new"] for r in res),
          f"tp_path (h): not every request DONE in full: {out['by_state']}")
    check(out["quarantines"] == 0, "tp_path (h): the sentinel flagged a step")
    ntok = out["prefill_tokens"] + out["decoded_tokens"]
    meter = eng.meter.measured_bytes()["total"]
    check(meter == traffic_model_for(eng.cfg).bytes_per_token() * ntok,
          f"tp_path (h): meter {meter} != eq. 7-10 x {ntok} tokens")
    k0 = sched.cache["k"][0]
    return {"requests": len(reqs), "prefills": clock.calls["prefill_slot"],
            "decode_steps": out["steps"], "launches": counts,
            "k_leaf_shape": list(k0.shape),
            "cache_bytes": eng.cache_stats(sched.cache)["cache_bytes"],
            "decode_s": clock.decode_s, "admit_s": clock.admit_s,
            "decode_steps_per_s": out["steps"] / clock.decode_s,
            "wall_s": out["wall_s"]}, [r.tokens.tolist() for r in res]


def tp_rank_seq(group, dev):
    """(h) on this rank: the engine, then :func:`tp_seq_run`."""
    t0 = time.perf_counter()
    eng = tp_seq_engine(dev, group)
    setup_s = time.perf_counter() - t0
    info, toks = tp_seq_run(eng)
    del eng
    return {**info, "setup_s": setup_s, "tokens": toks}


def tp_server_spec(vocab):
    """(i)'s scenario (``torch_tp_cases.online_scenario``'s spec): six
    seeded prompts of 4-8 tokens."""
    rng = np.random.default_rng(TP_SERVER["seed"])
    P = [rng.integers(1, vocab, int(rng.integers(4, 9))).tolist()
         for _ in range(6)]
    n = TP_SERVER["new"]
    return dict(slots=TP_SERVER["slots"], stall_at=TP_SERVER["stall_at"],
                stall_s=TP_SERVER["stall_s"],
                watchdog_s=TP_SERVER["watchdog_s"], requests=[
                    (P[0], n, {}), (P[1], n, {"deadline_s": 0.0}),
                    (P[2], 40, {"cancel_at": 2}), (P[3], n, {"raise_at": 2}),
                    (P[4], n, {}), (P[5], n, {"priority": 1})])


def tp_server_run(eng, group):
    """(i) on ``eng`` (a rank of ``group``, or one device): the
    OnlineServer scenario with the counts set to 0 just before and read
    just after, and its seconds."""
    from torch_tp_cases import online_scenario
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = online_scenario(eng, group, tp_server_spec(eng.cfg.vocab_size))
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_part_cfg(spec):
    cfg = get_config(spec["arch"])
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    return cfg


def tp_part_params(cfg, dev):
    """A part's seeded bf16 weights on ``dev``; a VLM's cross gates seeded
    non-zero (``xattn_gates``).  Every rank and the tp 1 engine draw the
    same tree."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = api.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    if cfg.cross_attn_every:
        params["cross"]["gate"] = xattn_gates(
            cfg.num_layers // cfg.cross_attn_every, gen)
    return params


def tp_part_engine(spec, dev, tp=None, **kw):
    cfg = tp_part_cfg(spec)
    params = tp_part_params(cfg, dev)
    eng = ServeEngine(cfg, params, device=dev, tp=tp, **kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return eng


def tp_gen_inputs(cfg, spec, dev, shape):
    """(B, T0) seeded prompts and, for a frontend config, B seeded
    frontends (float32 on ``dev``)."""
    B, T0 = shape
    rng = np.random.default_rng(spec["seed"])
    prompts = rng.integers(1, cfg.vocab_size, (B, T0)).astype(np.int32)
    fe = None
    if cfg.frontend_tokens:
        fgen = torch.Generator(device=dev).manual_seed(spec["seed"])
        fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                         generator=fgen, device=dev)
    return prompts, fe


def tp_generate(eng, prompts, fe, new, fused, keep_logits=False):
    """One counted ``generate()`` (counts set to 0 just before, read just
    after, meter reset): (tokens, launches, decode_s, meter bytes, the
    decode steps' logits or None)."""
    eng.meter.reset()
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    def call():
        if isinstance(eng, SplitBrainEngine):
            eng.fused = fused
            return eng.generate(prompts, max_new=new)
        return eng.generate(prompts, max_new=new, frontend=fe, fused=fused)
    if keep_logits:
        out, logits = _capture_decode_logits(call)
    else:
        out, logits = call(), None
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return (out["tokens"].tolist(), counts, out["decode_s"],
            eng.meter.measured_bytes()["total"], logits)


def tp_rank_moe(group, dev):
    """(d) on this rank: qwen3-moe at TP_MOE's depth under the scheduler on
    a paged pool with 8 slots; its tokens, every decode step's picks, the
    drop log's (rows, capacity, dropped) per call, launches and rates."""
    from repro_torch.models import moe
    spec = TP_MOE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = tp_part_engine(spec, dev, group, max_len=spec["max_len"],
                         page_size=MOE_PAGE)
    setup_s = time.perf_counter() - t0
    cfg = eng.cfg
    sched = ContinuousBatchingScheduler(eng, max_slots=MOE_SLOTS)
    sched.warmup(prompt_len=64, max_new=4)
    picks, decode = [], eng.decode_slots

    def record(cache, tokens, active, corrupt=None):
        nxt, ok, cache = decode(cache, tokens, active, corrupt)
        picks.append((np.asarray(nxt).tolist(), np.asarray(active).tolist()))
        return nxt, ok, cache
    eng.decode_slots = record
    clock = PhaseClock(eng)
    reqs = moe_requests(cfg.vocab_size, spec)
    log = moe.drop_log()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    drops = [(e["rows"], e["capacity"], int(e["dropped"])) for e in log]
    moe.drop_log(False)
    PhaseClock.detach(eng)
    res = sorted(out["results"], key=lambda r: r.uid)
    check(all(r.state == "DONE" for r in res),
          f"tp_path (d): not every request DONE: {out['by_state']}")
    prof = tp_rank_profile(eng)
    meter = eng.meter.measured_bytes()["total"]
    ntok = out["prefill_tokens"] + out["decoded_tokens"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * ntok,
          f"tp_path (d): meter {meter} != eq. 7-10 x {ntok} tokens")
    info = {"layers": cfg.num_layers, "experts": cfg.moe.num_experts,
            "top_k": cfg.moe.top_k, "requests": len(reqs),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefills": clock.calls["prefill_slot"],
            "decode_steps": out["steps"], "launches": counts,
            "kv_shards": eng.cache_stats(sched.cache)["kv_shards"],
            "setup_s": setup_s, "decode_s": clock.decode_s,
            "admit_s": clock.admit_s,
            "decode_steps_per_s": out["steps"] / clock.decode_s,
            "dropped_per_call": drops,
            "expert_bytes_per_layer": expert_bytes(cfg),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "profile": prof, "tokens": [r.tokens.tolist() for r in res],
            "picks": picks}
    del eng, sched
    return info


def tp_rank_xattn(group, dev, spec):
    """(e) or (f) on this rank: fused ``generate()`` (and stepwise where
    ``spec`` has a ``step``), counted, with the decode steps' rate and a
    profile of three decode steps."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    B, T0, new = spec["fused"]
    cfg = tp_part_cfg(spec)
    eng = tp_part_engine(spec, dev, group, max_len=T0 + new)
    setup_s = time.perf_counter() - t0
    prompts, fe = tp_gen_inputs(cfg, spec, dev, (B, T0))
    # warm-up: seamless prefills one decode step per prompt token, so it
    # warms up (and is profiled below) on 2-token prompts; its encoder's
    # launches are the same
    short = prompts[:, :2] if cfg.family == "encdec" else prompts
    eng.generate(short, max_new=2, frontend=fe)
    toks, counts, dec_s, meter, _ = tp_generate(eng, prompts, fe, new, True)
    ntok = B * (T0 - 1) + B * new
    check(meter == traffic_model_for(cfg).bytes_per_token() * ntok,
          f"tp_path {spec['arch']}: meter {meter} != eq. 7-10 x {ntok}")
    info = {"layers": cfg.num_layers, "fused": {
        "shape": spec["fused"], "tokens": toks, "launches": counts,
        "decode_s": dec_s, "decode_steps_per_s": new / dec_s}}
    if "step" in spec:
        sb, st, sn = spec["step"]
        stoks, scounts, sdec, _, _ = tp_generate(
            eng, prompts[:sb, :st], None if fe is None else fe[:sb], sn,
            False)
        info["stepwise"] = {"shape": spec["step"], "tokens": stoks,
                            "launches": scounts, "decode_s": sdec}
    prof = profile_generate(eng, dev, f"tp_path rank {group.rank}", short,
                            fe, n=PROFILE_STEPS)
    info.update(setup_s=setup_s,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                profile={k: prof[k] for k in (
                    "wall_ms_per_step", "device_ms_per_step",
                    "device_busy_share", "host_ops_per_step")})
    return info


def tp_rank_sb_generate(eng):
    """(g) on (a)'s engine: fused and eager ``generate()`` on TP_SB_GEN's
    prompts: tokens, launches, the meter's bytes per token."""
    B, T0, new = TP_SB_GEN
    rng = np.random.default_rng(SEED + 23)
    prompts = rng.integers(1, eng.cfg.vocab_size, (B, T0)).astype(np.int32)
    out = {}
    for fused in (True, False):
        toks, counts, dec_s, meter, _ = tp_generate(eng, prompts, None, new,
                                                    fused)
        out["fused" if fused else "eager"] = {
            "tokens": toks, "launches": counts, "decode_s": dec_s,
            "token_steps_per_s": (T0 - 1 + new) / dec_s,
            "meter_bytes_per_token": meter / (B * (T0 - 1 + new))}
    eng.fused = True
    return out


def tp_rank_online(eng, group):
    """(g) on (b)'s engine: two slots, priorities with preemption, a
    deadline and TP_ONLINE's chaos plan, the open-loop api as chaos_path
    (c) drives it; rank 1 sleeps TP_ONLINE["sleep_s"] at the top of every
    iteration, so its own clock runs apart from rank 0's, whose reading the
    group's loop clock broadcasts.  Returns what the ranks must agree on
    and what fired."""
    reqs = tp_serve_requests(eng.cfg.vocab_size, n=TP_ONLINE["requests"],
                             max_new=TP_ONLINE["new"])
    inj = FaultInjector(FaultPlan(**TP_ONLINE["plan"]), seed=SEED)
    if group.rank == 1:
        on_step = inj.on_step

        def late(sched):
            time.sleep(TP_ONLINE["sleep_s"])
            on_step(sched)
        inj.on_step = late
    sched = ContinuousBatchingScheduler(eng, max_slots=2, preemption=True,
                                        backoff_steps=1, faults=inj)
    sched.begin()
    for r in reqs[:2]:
        sched.submit(Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                             priority=0))
    while len(sched.decoding_uids()) < 2:
        sched.step()
    for _ in range(2):
        sched.step()
    sched.submit(Request(uid=reqs[2].uid, prompt=reqs[2].prompt,
                         max_new=reqs[2].max_new, priority=5))
    sched.submit(Request(uid=reqs[3].uid, prompt=reqs[3].prompt,
                         max_new=reqs[3].max_new, priority=0,
                         deadline_s=sched.clock() + 0.05))
    while sched.has_work():
        sched.step()
        check(sched._iterations < 2000, "tp_path (g) did not drain")
    torch.cuda.synchronize()
    res = sorted(sched.poll(), key=lambda r: r.uid)
    return {"tokens": [r.tokens.tolist() for r in res],
            "states": [r.state for r in res],
            "preemptions": [r.preemptions for r in res],
            "events": [{k: v for k, v in e.items() if k != "recovery_s"}
                       for e in sched.recovery_log],
            "fired": sorted({e[0] for e in inj.events}),
            "iterations": sched._iterations}


def tp_rank(grid, smi_line, t_spawn):
    """One rank of tp_path, on the ``(1, TP)`` grid's model group: (a),
    (b), (c) in turn, each engine freed before the next.  Every check
    raises here, which fails the run.  ``t_spawn``: the parent's
    ``time.time()`` at the spawn, for the rank's start-up seconds."""
    group = grid.model
    dev = group.device
    exact_matmuls()
    t_rank = time.perf_counter()
    res = {"rank": group.rank, "start_s": time.time() - t_spawn}
    parts, peaks, mark = {}, {}, [t_rank]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mark[0] = now

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the main path: split-brain tinyllama, W4A8 column blocks
    cfg = main_cfg()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = SplitBrainEngine(cfg, params, max_len=256, page_size=16,
                           quantize=True, device=dev, tp=group)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    heads = {n: tuple(w.codes.shape)
             for n, w in eng._layers[0]["attn"].items()}
    part("a_setup")
    run, toks = tp_rank_serve(eng, main_requests(cfg.vocab_size, n=8), 8)
    part("a_serve")
    res["a"] = {**run, "setup_s": setup_s, "layer0_attn_codes": heads,
                "head_codes": tuple(eng._head.codes.shape),
                "profile": tp_rank_profile(eng), "tokens": toks}
    part("a_profile")
    res["g_generate"] = tp_rank_sb_generate(eng)
    part("g_generate")
    res["i"] = tp_server_run(eng, group)
    part("i")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the float engine: llama2-7b at TP_LAYERS layers, full width
    cfg = dataclasses.replace(get_config("llama2-7b"), num_layers=TP_LAYERS)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, max_len=512, page_size=16, device=dev,
                      tp=group)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    part("b_setup")
    run, toks = tp_rank_serve(eng, tp_serve_requests(cfg.vocab_size), 64)
    part("b_serve")
    res["b"] = {**run, "setup_s": setup_s,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "profile": tp_rank_profile(eng), "tokens": toks}
    part("b_profile")
    res["g_online"] = tp_rank_online(eng, group)
    part("g_online")
    del eng
    free()
    res["c"] = tp_rank_paged(group, dev)
    part("c")
    res["d"] = tp_rank_moe(group, dev)
    free()
    part("d")
    res["e"] = tp_rank_xattn(group, dev, TP_VISION)
    free()
    part("e")
    res["f"] = tp_rank_xattn(group, dev, TP_ENCDEC)
    free()
    part("f")
    res["h"] = tp_rank_seq(group, dev)
    free()
    part("h")
    res["wall_s"] = time.perf_counter() - t_rank
    res["parts_s"] = parts
    res["parts_peak_memory_bytes"] = peaks
    return res


def phase_tp_path(dev, smi_line, clean=None):
    """tp_path: two ranks on the one card; (a)'s tokens against ``clean``,
    main_path's tokens of the same 8 requests (a split-brain request's
    tokens do not depend on the others it is batched with; without
    ``clean`` a tp 1 engine serves them here), (b)'s against a tp 1 engine
    of the same depth built here."""
    from repro_torch.distributed import runtime
    t0 = time.perf_counter()
    L = MAIN_LAYERS
    if clean is None:
        cfg = main_cfg()
        params = api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        eng = SplitBrainEngine(cfg, params, max_len=256, page_size=16,
                               quantize=True, device=dev)
        del params
        out = ContinuousBatchingScheduler(eng, max_slots=8).run(
            main_requests(cfg.vocab_size, n=8))
        clean = [r.tokens.tolist() for r in out["results"]]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    backend, devices = runtime.plan((1, TP), dev)
    ranks = runtime.spawn(tp_rank, (1, TP), (smi_line, time.time()),
                          backend=backend, devices=devices, timeout=900)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        a = r["a"]
        steps, prefill = a["decode_steps"], a["prefill_tokens"]
        want = {"w4a8_matmul": (7 * L + 1) * (prefill + steps),
                "paged_decode_attention": L * steps, "flash_attention": 0,
                "rwkv6_scan": 0}
        check(a["launches"] == want, f"tp_path (a) rank {r['rank']}: "
              f"launches {a['launches']} != {want}")
        check(a["tokens"] == clean, f"tp_path (a) rank {r['rank']}: tokens "
              f"differ from the tp 1 engine's")
        check(a["kv_shards"] == TP and a["traffic_shards"] == TP,
              f"tp_path (a): kv_shards {a['kv_shards']}")
        check(a["meter_bytes_per_token"]
              == traffic_model_for(main_cfg())
              .bytes_per_token(), "tp_path (a): meter bytes per token")
        b = r["b"]
        want = {"w4a8_matmul": 0, "flash_attention": TP_LAYERS * b["requests"],
                "paged_decode_attention": TP_LAYERS * b["decode_steps"],
                "rwkv6_scan": 0}
        check(b["launches"] == want, f"tp_path (b) rank {r['rank']}: "
              f"launches {b['launches']} != {want}")
        check(b["kv_shards"] == TP, f"tp_path (b): kv_shards {b['kv_shards']}")
    check(ranks[0]["b"]["tokens"] == ranks[1]["b"]["tokens"],
          "tp_path (b): the ranks decoded different tokens")
    # (b)'s tp 1 engine: the same depth, weights and requests
    cfg = dataclasses.replace(get_config("llama2-7b"), num_layers=TP_LAYERS)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, max_len=512, page_size=16, device=dev)
    del params
    reqs = tp_serve_requests(cfg.vocab_size)
    out = ContinuousBatchingScheduler(eng, max_slots=8).run(reqs)
    one = [r.tokens.tolist() for r in sorted(out["results"],
                                             key=lambda r: r.uid)]
    ties = []
    for r, want, got in zip(reqs, one, ranks[0]["b"]["tokens"]):
        rep = tie_report(serve_logits_fn(eng), r.prompt, want, got)
        if rep is not None:
            rep["uid"] = r.uid
            ties.append(rep)
            check(rep["near_tie"], f"tp_path (b): request {r.uid} left the "
                  f"tp 1 tokens at a pick that is no near-tie: {rep}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    new_parts, tp1_s = tp_path_new_parts(ranks, dev)
    per_rank = []
    for r in ranks:
        row = {"rank": r["rank"], "wall_s": r["wall_s"],
               "start_s": r["start_s"], "parts_s": r["parts_s"],
               "parts_peak_memory_bytes": r["parts_peak_memory_bytes"]}
        for part in ("a", "b", "d", "e", "f", "h"):
            row[part] = {k: v for k, v in r[part].items()
                         if k not in ("tokens", "picks", "dropped_per_call")}
        row["i"] = {k: r["i"][k] for k in ("launches", "seconds", "stats",
                                          "prefill_tokens", "decode_steps")}
        row["g_generate"] = {m: {k: v for k, v in g.items() if k != "tokens"}
                             for m, g in r["g_generate"].items()}
        row["c"] = r["c"]
        per_rank.append(row)
    info = {"phase": "tp_path", "tp": TP, "backend": backend,
            "devices": devices, "ranks": per_rank,
            "a": {"config": "tinyllama-1.1b", "layers": L,
                  "tokens_identical_to_tp1": True,
                  "launches_per_token_step": {"w4a8_matmul": 7 * L + 1,
                                              "paged_decode_attention": L}},
            "b": {"config": "llama2-7b", "layers": TP_LAYERS,
                  "tokens_identical_to_tp1": not ties,
                  "first_divergences": ties},
            "c": {"merge": TP_MERGE, "head_cut": TP_HEADS},
            **new_parts, "tp1_s": tp1_s,
            "seconds": time.perf_counter() - t0, "spawn_s": spawn_s,
            "card": smi_line}
    emit(info)
    r0 = ranks[0]
    info["launches"] = {k: r0["a"]["launches"][k] + r0["b"]["launches"][k]
                        + r0["d"]["launches"][k] + r0["h"]["launches"][k]
                        + r0["i"]["launches"][k]
                        + sum(r0[p][m]["launches"][k]
                              for p, m in (("e", "fused"), ("e", "stepwise"),
                                           ("f", "fused"),
                                           ("g_generate", "fused"),
                                           ("g_generate", "eager")))
                        for k in r0["a"]["launches"]}
    info["prompt_lens_d"] = r0["d"]["prompt_lens"]
    info["launches_rank0"] = {
        "d": r0["d"]["launches"],
        "e": {k: r0["e"]["fused"]["launches"][k]
              + r0["e"]["stepwise"]["launches"][k]
              for k in r0["e"]["fused"]["launches"]},
        "f": r0["f"]["fused"]["launches"]}
    return info


def tp_tie(logits, a, b):
    """The gap between picks ``a`` and ``b`` in one row of the tp 1 run's
    logits, and whether it is a near-tie (``tie_report``'s rule: within
    NEAR_TIE_ULPS bf16 ulps of the row's largest |logit|)."""
    row = logits.float().cpu()
    gap = abs(row[a].item() - row[b].item())
    tol = NEAR_TIE_ULPS * bf16_ulp_of(row.abs().max().item())
    return {"tp1": a, "rank": b, "gap": gap, "tolerance": tol,
            "near_tie": gap <= tol}


def tp_hold_generate(name, want, got, logits, new):
    """A rank's ``generate()`` tokens against the tp 1 run's: identical, or
    every row's first differing pick a near-tie in the tp 1 run's logits
    of that step (``logits``: its decode steps, the last ``new`` of them
    the generated tokens')."""
    want, got = np.asarray(want), np.asarray(got)
    ties = []
    for row in np.flatnonzero((want != got).any(axis=1)):
        j = int(np.flatnonzero(want[row] != got[row])[0])
        rep = tp_tie(logits[-new:][j][row], int(want[row, j]),
                     int(got[row, j]))
        rep.update(row=int(row), step=j)
        check(rep["near_tie"], f"tp_path {name}: row {row} left the tp 1 "
              f"tokens at a pick that is no near-tie: {rep}")
        ties.append(rep)
    return ties


def tp_path_new_parts(ranks, dev):
    """tp_path (d)-(g) in the parent, after the ranks have finished: each
    part's pins per rank, the ranks' agreement, and the tp 1 engines of
    the same depth built here, one at a time, against rank 0's tokens.
    Returns (the parts' report, the tp 1 runs' seconds)."""
    r0, L = ranks[0], MAIN_LAYERS
    B, T0, new = TP_SB_GEN
    for r in ranks:
        d = r["d"]
        Ld = TP_MOE["layers"]
        want = {"w4a8_matmul": 0, "flash_attention": Ld * d["prefills"],
                "paged_decode_attention": Ld * d["decode_steps"],
                "rwkv6_scan": 0}
        check(d["launches"] == want, f"tp_path (d) rank {r['rank']}: "
              f"launches {d['launches']} != {want}")
        check(d["kv_shards"] == TP, f"tp_path (d): kv_shards {d['kv_shards']}")
        Lv = TP_VISION["layers"]
        G = Lv // get_config(TP_VISION["arch"]).cross_attn_every
        vn = TP_VISION["fused"][2]
        _, st, sn = TP_VISION["step"]
        for mode, flash in (("fused", Lv + G + G * vn),
                            ("stepwise", G * (st - 1 + sn))):
            want = {"w4a8_matmul": 0, "flash_attention": flash,
                    "paged_decode_attention": 0, "rwkv6_scan": 0}
            check(r["e"][mode]["launches"] == want, f"tp_path (e) {mode} "
                  f"rank {r['rank']}: {r['e'][mode]['launches']} != {want}")
        enc = get_config(TP_ENCDEC["arch"]).num_encoder_layers
        want = {"w4a8_matmul": 0, "flash_attention": enc,
                "paged_decode_attention": 0, "rwkv6_scan": 0}
        check(r["f"]["fused"]["launches"] == want, f"tp_path (f) rank "
              f"{r['rank']}: {r['f']['fused']['launches']} != {want}")
        for mode in ("fused", "eager"):
            g = r["g_generate"][mode]
            want = {"w4a8_matmul": (7 * L + 1) * (T0 - 1 + new),
                    "paged_decode_attention": 0, "flash_attention": 0,
                    "rwkv6_scan": 0}
            check(g["launches"] == want, f"tp_path (g) {mode} generate() "
                  f"rank {r['rank']}: {g['launches']} != {want}")
            check(g["meter_bytes_per_token"]
                  == traffic_model_for(main_cfg()).bytes_per_token(),
                  f"tp_path (g) {mode}: meter bytes per token")
    def tokens_of(part):
        return {m: v["tokens"] for m, v in part.items()
                if isinstance(v, dict) and "tokens" in v}
    for r in ranks[1:]:
        check(r["g_online"] == r0["g_online"], "tp_path (g): the ranks' "
              "tokens, request states or recovery events differ")
        check(r["d"]["tokens"] == r0["d"]["tokens"]
              and r["d"]["picks"] == r0["d"]["picks"]
              and r["d"]["dropped_per_call"] == r0["d"]["dropped_per_call"],
              "tp_path (d): the ranks' tokens, picks or drop logs differ")
        for key in ("e", "f", "g_generate"):
            check(tokens_of(r[key]) == tokens_of(r0[key]),
                  f"tp_path ({key}): the ranks decoded different tokens")
    online = r0["g_online"]
    check(set(TP_ONLINE["plan"]) >= {"step_corrupt_at", "device_loss_at"}
          and {"step_corrupt", "device_loss"} <= set(online["fired"]),
          f"tp_path (g): a planned fault never fired: {online['fired']}")
    out, tp1_s = {}, {}
    # (g) split-brain generate() against tp 1
    t0 = time.perf_counter()
    cfg = main_cfg()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = SplitBrainEngine(cfg, params, max_len=256, page_size=16,
                           quantize=True, device=dev)
    del params
    one = tp_rank_sb_generate(eng)
    for mode in ("fused", "eager"):
        check(r0["g_generate"][mode]["tokens"] == one[mode]["tokens"],
              f"tp_path (g): {mode} generate() tokens differ from tp 1's")
    tp1_s["g_generate"] = time.perf_counter() - t0
    # (i) the OnlineServer against one device's, on the same engine
    t0 = time.perf_counter()
    out["i"] = tp_hold_server(ranks, tp_server_run(eng, None))
    tp1_s["i"] = time.perf_counter() - t0
    del eng
    # (d) qwen3-moe against tp 1, every decode step's logits kept
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.serve import engine as engine_mod
    eng = tp_part_engine(TP_MOE, dev, max_len=TP_MOE["max_len"],
                         page_size=MOE_PAGE)
    sched = ContinuousBatchingScheduler(eng, max_slots=MOE_SLOTS)
    sched.warmup(prompt_len=64, max_new=4)
    kept, corrupt = [], engine_mod.slots_mod.corrupt_logits

    def keep(logits, bad):
        kept.append(logits.clone())
        return corrupt(logits, bad)
    engine_mod.slots_mod.corrupt_logits = keep
    try:
        res = sched.run(moe_requests(eng.cfg.vocab_size, TP_MOE))
    finally:
        engine_mod.slots_mod.corrupt_logits = corrupt
    one = [r.tokens.tolist() for r in sorted(res["results"],
                                             key=lambda r: r.uid)]
    tie = None
    if one != r0["d"]["tokens"]:
        picks = [torch.argmax(k, dim=-1).tolist() for k in kept]
        for k, (got, active) in enumerate(r0["d"]["picks"]):
            bad = [i for i, a in enumerate(active)
                   if a and got[i] != picks[k][i]]
            if bad:
                i = bad[0]
                tie = tp_tie(kept[k][i], picks[k][i], got[i])
                tie.update(decode_step=k, slot=i)
                break
        check(tie is not None and tie["near_tie"], f"tp_path (d): the "
              f"tokens left tp 1's at a pick that is no near-tie: {tie}")
    out["d"] = {"config": eng.cfg.name, "layers": TP_MOE["layers"],
                "tokens_identical_to_tp1": tie is None,
                "first_divergence": tie,
                "identical_requests": sum(a == b for a, b in
                                          zip(one, r0["d"]["tokens"])),
                "ranks_drop_logs_equal": True,
                "dropped_assignments": sum(c[2] for c in
                                           r0["d"]["dropped_per_call"])}
    del eng, sched, kept
    tp1_s["d"] = time.perf_counter() - t0
    # (e), (f) generate() against tp 1
    for key, spec in (("e", TP_VISION), ("f", TP_ENCDEC)):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        Bx, Tx, nx = spec["fused"]
        eng = tp_part_engine(spec, dev, max_len=Tx + nx)
        cfg = eng.cfg
        prompts, fe = tp_gen_inputs(cfg, spec, dev, (Bx, Tx))
        toks, _, _, _, logits = tp_generate(eng, prompts, fe, nx, True,
                                            keep_logits=True)
        ties = tp_hold_generate(f"({key}) fused", toks,
                                r0[key]["fused"]["tokens"], logits, nx)
        part = {"config": cfg.name, "layers": cfg.num_layers,
                "fused": {"tokens_identical_to_tp1": not ties,
                          "first_divergences": ties}}
        if "step" in spec:
            sb, st, sn = spec["step"]
            stoks, _, _, _, slog = tp_generate(
                eng, prompts[:sb, :st], fe[:sb], sn, False, keep_logits=True)
            ties = tp_hold_generate(f"({key}) stepwise", stoks,
                                    r0[key]["stepwise"]["tokens"], slog, sn)
            part["stepwise"] = {"tokens_identical_to_tp1": not ties,
                                "first_divergences": ties}
        out[key] = part
        del eng, logits
        tp1_s[key] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # (h) the sequence cut against one device's engine with the knob
    t0 = time.perf_counter()
    out["h"] = tp_hold_seq(ranks, dev)
    tp1_s["h"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["g"] = {"generate": {"config": main_cfg().name,
                             "tokens_identical_to_tp1": True,
                             "launches_per_token_step": 7 * L + 1},
                "online": {k: online[k] for k in (
                    "states", "preemptions", "events", "fired",
                    "iterations")},
                "online_ranks_equal": True}
    return out, tp1_s


def tp_hold_seq(ranks, dev):
    """(h)'s pins per rank (TP_LAYERS flash launches per prefill, no paged
    launch, every KV head of 512 of the 1,024 positions in a K/V leaf),
    the ranks' tokens equal, and tp 1's engine with the knob on the same
    requests: identical tokens, or the first differing pick a near-tie in
    its logits (``tie_report``, as (b))."""
    r0 = ranks[0]["h"]
    for r in ranks:
        h = r["h"]
        want = {"w4a8_matmul": 0, "paged_decode_attention": 0,
                "flash_attention": TP_LAYERS * h["prefills"],
                "rwkv6_scan": 0}
        check(h["launches"] == want, f"tp_path (h) rank {r['rank']}: "
              f"launches {h['launches']} != {want}")
        check(h["prefills"] == TP_SEQ["requests"],
              f"tp_path (h): {h['prefills']} prefills")
        check(h["k_leaf_shape"][-3:-1] == [32, TP_SEQ["max_len"] // TP],
              f"tp_path (h): a rank's K leaf {h['k_leaf_shape']}")
        check(h["tokens"] == r0["tokens"],
              "tp_path (h): the ranks decoded different tokens")
    eng = tp_seq_engine(dev)
    info, one = tp_seq_run(eng)
    ties = []
    for r, want, got in zip(tp_seq_requests(eng.cfg.vocab_size), one,
                            r0["tokens"]):
        rep = tie_report(serve_logits_fn(eng), r.prompt, want, got)
        if rep is not None:
            rep["uid"] = r.uid
            ties.append(rep)
            check(rep["near_tie"], f"tp_path (h): request {r.uid} left the "
                  f"tp 1 tokens at a pick that is no near-tie: {rep}")
    del eng
    return {"config": "llama2-7b", "layers": TP_LAYERS,
            "decode_attn": "shard_map", "max_len": TP_SEQ["max_len"],
            "tokens_identical_to_tp1": not ties, "first_divergences": ties,
            "identical_requests": sum(a == b for a, b in
                                      zip(one, r0["tokens"])),
            "rank_k_leaf_shape": r0["k_leaf_shape"],
            "rank_cache_bytes": r0["cache_bytes"],
            "b_rank_cache_bytes_head_cut": ranks[0]["b"]["cache_bytes"],
            "tp1_cache_bytes": info["cache_bytes"],
            "flash_launches_per_prefill_per_rank": TP_LAYERS,
            "tp1_decode_steps_per_s": info["decode_steps_per_s"]}


def tp_hold_server(ranks, one):
    """(i)'s checks: per rank 43 W4A8 launches per token step (the
    scheduler's prefill tokens and decode steps) and MAIN_LAYERS paged
    launches per decode step, no flash; the ranks' tokens, states,
    recovery events and fired faults equal; rank 0's streamed tokens its
    results; the states of the scenario; one watchdog recovery; and the
    tokens of one device's OnlineServer (``one``) on the same requests (the
    client's cancellation, uid 2, lands when it lands: a prefix)."""
    L = MAIN_LAYERS
    r0 = ranks[0]["i"]
    for r in ranks:
        i = r["i"]
        steps = i["prefill_tokens"] + i["decode_steps"]
        want = {"w4a8_matmul": (7 * L + 1) * steps,
                "paged_decode_attention": L * i["decode_steps"],
                "flash_attention": 0, "rwkv6_scan": 0}
        check(i["launches"] == want, f"tp_path (i) rank {r['rank']}: "
              f"launches {i['launches']} != {want}")
        for key in ("tokens", "states", "events", "fired"):
            check(i[key] == r0[key], f"tp_path (i): the ranks' {key} differ")
    states = {0: "DONE", 1: "TIMEOUT", 2: "CANCELLED", 3: "CANCELLED",
              4: "DONE", 5: "DONE"}
    check(r0["states"] == states == one["states"]
          and r0["handles"] == states,
          f"tp_path (i): states {r0['states']} / {one['states']}")
    check(all(r0["streamed"][u] == t for u, t in r0["tokens"].items()),
          "tp_path (i): streamed tokens differ from the results")
    recov = [e for e in r0["events"] if e["event"] == "recover"]
    check(len(recov) == 1 and "watchdog" in recov[0]["reason"]
          and r0["fired"] == ["step_stall"],
          f"tp_path (i): recoveries {r0['events']}, faults {r0['fired']}")
    for uid, toks in r0["tokens"].items():
        ref_t = one["tokens"][uid]
        n = min(len(toks), len(ref_t)) if uid == 2 else len(ref_t)
        check(toks[:n] == ref_t[:n] and (uid == 2 or toks == ref_t),
              f"tp_path (i): request {uid}'s tokens differ from tp 1's")
    check(len(r0["tokens"][3]) == 2 and r0["tokens"][1] == [],
          "tp_path (i): the raising consumer or the deadline")
    return {"config": main_cfg().name, "layers": L,
            "states": r0["states"], "events": r0["events"],
            "stats": r0["stats"], "tokens_identical_to_tp1": True,
            "ranks_equal": True,
            "launches_per_token_step": 7 * L + 1,
            "prefill_tokens": r0["prefill_tokens"],
            "decode_steps": r0["decode_steps"],
            "rank_seconds": [r["i"]["seconds"] for r in ranks],
            "tp1_seconds": one["seconds"]}


FEATURE_PAGE, FEATURE_LEN, FEATURE_CHUNK, FEATURE_SLOTS = 16, 1024, 64, 8
FLIP_GATE = 0.05        # the JAX package's serve_bench gate on int8 / fp8


def features_requests(vocab, max_new=32):
    """16 requests: 12 share a 512-token prefix (32 pages) and add their own
    tail of 16-128 tokens, 4 share nothing (64-256 tokens), interleaved;
    uid 0 is a shared-prefix request."""
    rng = np.random.default_rng(SEED + 20)
    prefix = rng.integers(1, vocab, 512).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(
        1, vocab, int(rng.integers(16, 129))).astype(np.int32)])
        for _ in range(12)]
    other = [rng.integers(1, vocab, int(rng.integers(64, 257))).astype(
        np.int32) for _ in range(4)]
    prompts = (shared[:2] + other[:1] + shared[2:4] + other[1:2]
               + shared[4:6] + other[2:3] + shared[6:8] + other[3:]
               + shared[8:])
    return [Request(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


def flip_rate(base, other):
    """Greedy-token divergence of ``other`` from ``base`` (results sorted by
    uid), as the JAX package's serve_bench counts it: first-flip events per
    aligned token compared up to and including each request's first
    mismatch (the per-step probability of a flipped argmax), and the share
    of all aligned tokens that differ."""
    total = diverged = flips = compared = 0
    for a, b in zip(base, other):
        n = min(len(a.tokens), len(b.tokens))
        total += max(len(a.tokens), len(b.tokens))
        neq = np.asarray(a.tokens[:n]) != np.asarray(b.tokens[:n])
        diverged += int(neq.sum()) + max(len(a.tokens), len(b.tokens)) - n
        flips += int(neq.any())
        compared += (int(np.argmax(neq)) + 1) if neq.any() else n
    return flips / max(compared, 1), diverged / max(total, 1)


def serve_features(eng, reqs, chunk, slots, name, warm=True):
    """Serve ``reqs`` on ``eng`` with chunked prefill, the first request
    alone until it decodes (its prefix pages are published first), the rest
    then through the scheduler's submit/step lifecycle; a warm-up run
    first (``warm``), the launch counts set to 0 just before and read just
    after.  Returns (results, info)."""
    sched = ContinuousBatchingScheduler(eng, max_slots=slots,
                                        prefill_chunk=chunk)
    clock = PhaseClock(eng)
    if warm:
        sched.warmup(prompt_len=64, max_new=4)
    clock.reset()
    eng.meter.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_staged([sched], [reqs], max_iters=20000)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"{name}: not every request DONE: {[r.state for r in res]}")
    check(all(r.gen_len == q.max_new for q, r in zip(reqs, res)),
          f"{name}: a request stopped short")
    check(all(0 <= t < eng.cfg.vocab_size for r in res for t in r.tokens),
          f"{name}: token out of range")
    steps = clock.calls["decode_slots"]
    cached = [r.cached_tokens for r in res]
    prefill = sum(len(q.prompt) - 1 for q in reqs) - sum(cached)
    decoded = sum(r.gen_len for r in res)
    stats = eng.cache_stats(sched.cache)
    info = {"run": name, "decode_steps": steps, "prefill_tokens": prefill,
            "decoded_tokens": decoded, "cached_tokens": cached,
            "launches": counts, "wall_s": wall, "decode_s": clock.decode_s,
            "admit_s": clock.admit_s,
            "decode_steps_per_s": steps / clock.decode_s,
            "decode_tokens_per_s": decoded / clock.decode_s,
            "prefill_tokens_per_s": prefill / clock.admit_s,
            "tokens_per_s_wall": decoded / wall,
            "peak_memory_bytes": peak,
            "meter_bytes": eng.meter.measured_bytes()["total"],
            "host_channels": {ch: eng.meter.host_channel_bytes(ch) for ch in
                              ("kv_cache_read", "prefix_prefill_saved",
                               "page_cow_copy")},
            "cache": stats}
    PhaseClock.detach(eng)
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return res, info


def phase_features_path(serve_eng, dev, smi_line):
    """Full-width llama2-7b on the serve path's weights (built once) with
    the KV-cache features: pages of 16, max_len 1024, 8 slots, prefill
    chunks of 64, on features_requests (12 of 16 requests share a 512-token
    prefix).  Runs: (a) bf16 pool, prefix off; (b) bf16, prefix on;
    (c) int8, prefix on; (d) fp8, prefix on."""
    t_path = time.perf_counter()
    cfg = serve_eng.cfg
    PhaseClock.detach(serve_eng)                # the serve path's clock
    reqs = features_requests(cfg.vocab_size)
    L = cfg.num_layers
    runs, results, engines = {}, {}, {}
    for name, opts in (("a_bf16_prefix_off", dict(prefix_cache="off")),
                       ("b_bf16_prefix_on", dict(prefix_cache="on")),
                       ("c_int8_prefix_on", dict(prefix_cache="on",
                                                 kv_dtype="int8")),
                       ("d_fp8_prefix_on", dict(prefix_cache="on",
                                                kv_dtype="fp8"))):
        eng = serve_eng.with_paging(page_size=FEATURE_PAGE, **opts)
        check(eng.params is serve_eng.params, "the weights were copied")
        res, info = serve_features(eng, reqs, FEATURE_CHUNK, FEATURE_SLOTS,
                                   name)
        want = {"w4a8_matmul": 0, "flash_attention": 0, "rwkv6_scan": 0,
                "paged_decode_attention": L * info["decode_steps"]}
        check(info["launches"] == want,
              f"{name}: launch counts {info['launches']} != {want}")
        runs[name], results[name] = info, res
        engines[name] = eng
    a, b = results["a_bf16_prefix_off"], results["b_bf16_prefix_on"]
    ra, rb = runs["a_bf16_prefix_off"], runs["b_bf16_prefix_on"]
    check([r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b],
          "prefix on and off gave other tokens")
    hits = sum(c >= 512 for c in rb["cached_tokens"])
    check(hits >= 11, f"only {hits} prefix hits of 512 or more tokens")
    check(rb["cache"]["pages_allocated"] < ra["cache"]["pages_allocated"],
          f"prefix on stored {rb['cache']['pages_allocated']} pages, off "
          f"{ra['cache']['pages_allocated']}")
    check(sum(ra["cached_tokens"]) == 0, "prefix off reused a prefix")
    quant = {}
    for name, kv in (("c_int8_prefix_on", "int8"), ("d_fp8_prefix_on", "fp8")):
        rq, st = runs[name], runs[name]["cache"]
        per_tok = pages.kv_token_bytes_quant(
            api.init_cache(cfg, 2, FEATURE_LEN, device=torch.device("meta")),
            serve_eng._ba, serve_eng._sa, FEATURE_PAGE, kv)
        tokens = st["num_pages"] * st["page_size"]
        check(st["kv_dtype"] == kv and st["kv_token_bytes_stored"] == per_tok
              and st["pool_bytes"] == tokens * per_tok,
              f"{name}: pool bytes {st['pool_bytes']} over {tokens} token "
              f"positions != kv_token_bytes_quant {per_tok}")
        check(rq["meter_bytes"] == rb["meter_bytes"],
              f"{name}: boundary bytes {rq['meter_bytes']} != bf16's "
              f"{rb['meter_bytes']}")
        check(rq["cached_tokens"] == rb["cached_tokens"],
              f"{name}: other prefix hits than bf16's")
        fr, div = flip_rate(b, results[name])
        quant[kv] = {"token_flip_rate": fr, "token_divergence_frac": div,
                     "within_reference_gate": fr <= FLIP_GATE,
                     "resident_tokens_per_pool_byte": tokens / st[
                         "pool_bytes"],
                     "kv_token_bytes_quant": per_tok,
                     "bf16_kv_token_bytes": rb["cache"][
                         "kv_token_bytes_stored"]}
    info = {"phase": "features_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                              cfg.num_kv_heads],
            "max_slots": FEATURE_SLOTS, "page_size": FEATURE_PAGE,
            "max_len": FEATURE_LEN, "prefill_chunk": FEATURE_CHUNK,
            "requests": len(reqs), "prompt_lens": [len(r.prompt)
                                                    for r in reqs],
            "all_done": True, "prefix_on_off_identical": True,
            "prefix_hits_512": hits, "runs": runs, "quantized": quant,
            "flash_launches_in_chunked_prefill": 0,
            "path_s": time.perf_counter() - t_path, "card": smi_line}
    emit(info)
    return engines["c_int8_prefix_on"], info


def phase_features_splitbrain(main_eng, dev, smi_line):
    """Full-width tinyllama-1.1b split-brain (LAQ W4A8, the main path's
    weights) with an int8 prefix-shared pool, pages of 16, 8 slots and
    prefill chunks of 32, on the main path's traffic behind a shared
    128-token prefix: 43 W4A8 launches per token step and 6 paged launches
    per decode step; then a short run on a dense slot cache and one on a
    paged bf16 pool: the same tokens."""
    t_path = time.perf_counter()
    cfg = main_eng.cfg
    PhaseClock.detach(main_eng)                 # the main path's clock
    rng = np.random.default_rng(SEED + 21)
    prefix = rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
    reqs = [Request(uid=r.uid, prompt=np.concatenate([prefix, r.prompt]),
                    max_new=r.max_new)
            for r in main_requests(cfg.vocab_size)]
    eng = main_eng.with_paging(page_size=16, prefix_cache="on",
                               kv_dtype="int8")
    res, info = serve_features(eng, reqs, 32, 8, "splitbrain_int8_prefix_on")
    L = cfg.num_layers
    steps = info["decode_steps"]
    want = {"w4a8_matmul": (7 * L + 1) * (info["prefill_tokens"] + steps),
            "paged_decode_attention": L * steps, "flash_attention": 0,
            "rwkv6_scan": 0}
    check(info["launches"] == want,
          f"split-brain features: launch counts {info['launches']} != {want}")
    check(sum(c >= 128 for c in info["cached_tokens"]) >= 15,
          f"split-brain prefix hits {info['cached_tokens']}")
    tokens = info["prefill_tokens"] + info["decoded_tokens"]
    check(info["meter_bytes"] == traffic_model_for(cfg).bytes_per_token()
          * tokens, "split-brain features: meter not eq. 7-10 exact")
    # the dense slot cache against the paged pool, both bf16: the gather
    # discipline runs the dense token step on the pool's gathered view, so
    # their tokens are identical; in place, the paged kernel sums in
    # another order than the plain dense attention (one bf16 ulp), so its
    # agreement at full width's near-ties is reported, not required
    short = [Request(uid=r.uid, prompt=r.prompt, max_new=8)
             for r in main_requests(cfg.vocab_size)[:4]]
    toks = {}
    for name, kw in (("dense", dict()),
                     ("paged_gather", dict(page_size=16,
                                           paged_attn="gather")),
                     ("paged_inplace", dict(page_size=16))):
        res2, _ = serve_features(main_eng.with_paging(**kw), short, 32, 4,
                                 "splitbrain_" + name, warm=False)
        toks[name] = [r.tokens.tolist() for r in res2]
    check(toks["dense"] == toks["paged_gather"],
          "the dense slot cache gave other tokens than the paged pool")
    info.update({"phase": "features_splitbrain", "config": cfg.name,
                 "layers": L, "page_size": 16, "max_len": main_eng.max_len,
                 "prefill_chunk": 32, "kv_dtype": "int8",
                 "w4a8_per_token_step": info["launches"]["w4a8_matmul"]
                 / (info["prefill_tokens"] + steps),
                 "paged_per_decode_step":
                     info["launches"]["paged_decode_attention"] / steps,
                 "dense_equals_paged_gather": True,
                 "dense_vs_paged_inplace_identical_requests": sum(
                     a == b for a, b in zip(toks["dense"],
                                            toks["paged_inplace"])),
                 "path_s": time.perf_counter() - t_path, "card": smi_line})
    emit(info)
    return info


def rwkv_requests(vocab, n=8, max_new=32):
    rng = np.random.default_rng(SEED + 8)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, int(rng.integers(16, 65)))
                    .astype(np.int32),
                    max_new=max_new) for i in range(n)]


# rwkv_path runs 16 of the 32 layers at full width (cut when moe_path
# joined, to keep the script inside its time limit: its per-token prefill
# grows with the depth); the scan's times phase keeps the 32-layer forward
RWKV_LAYERS = 16


def phase_rwkv_path(dev, smi_line):
    """Full-width rwkv6-7b at RWKV_LAYERS of its 32 layers: the
    whole-sequence forward (the scan kernel, one launch per layer), then
    the float ServeEngine under the scheduler."""
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=RWKV_LAYERS)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    eng = ServeEngine(cfg, params, max_len=128, device=dev)
    del params                      # the f32 tree: the engine keeps bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    # --- forward on 4 x 512 tokens, twice
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 9))
    torch.cuda.reset_peak_memory_stats()
    zero = {name: 0 for name in ops.KERNELS}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runs = []
    for _ in range(2):
        before = ops.launch_counts()
        t = time.perf_counter()
        logits, _ = api.forward(eng.params, toks, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = ops.launch_counts()
        check({k: after[k] - before[k] for k in after} == {**zero, "rwkv6_scan": L},
              f"forward launch counts {before} -> {after}: not {L} scans")
        runs.append((logits, dt))
    fwd_counts = ops.launch_counts()
    fwd_peak = torch.cuda.max_memory_allocated()
    (l1, dt1), (l2, dt2) = runs
    check(l1.shape == (4, 512, cfg.vocab_size) and l1.dtype == torch.float32
          and bool(torch.isfinite(l1).all()), "forward logits not finite or "
          "of the wrong shape")
    check(torch.equal(l1, l2), "a second forward gave other logits")
    fwd_max = l1.abs().max().item()
    del runs, l1, l2, logits
    # --- serving: 8 requests over 8 slots, dense recurrent-state slot cache
    sched = ContinuousBatchingScheduler(eng, max_slots=8)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=16, max_new=4)
    reqs = rwkv_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == 32 for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    check(counts == zero, f"serve launch counts {counts}: the rwkv serve path "
          "launches no kernel")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    info = {"phase": "rwkv_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": cfg.d_model // 64, "head_dim": 64,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "setup_s": setup_s, "setup_peak_memory_bytes": setup_peak,
            "forward": {"batch": 4, "tokens": 512, "launches": fwd_counts,
                        "seconds": [dt1, dt2], "tokens_per_s": 2048 / dt2,
                        "max_abs_logit": fwd_max, "second_identical": True,
                        "peak_memory_bytes": fwd_peak},
            "max_slots": 8, "max_len": 128, "requests": len(reqs),
            "all_done": True, "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "serve_launches": counts, "meter_bytes": meter,
            "second_run_identical": True,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "peak_memory_bytes": peak, "launches": fwd_counts,
            "card": smi_line}
    emit(info)
    return eng, info


GEMMA2_SLOTS, GEMMA2_MAX_LEN, GEMMA2_NEW = 4, 8192, 32
GEMMA2_GENERATE = (2, 2048, 16)      # generate(): batch, prompt, new tokens


def gemma2_requests(vocab, max_new=GEMMA2_NEW):
    """Two long prompts (4,070 and 4,085 tokens: they fit the 4096-token
    ring, and their decode crosses position 4096) and six of 256-1,024."""
    rng = np.random.default_rng(SEED + 11)
    lens = [4070, 4085] + [int(n) for n in rng.integers(256, 1025, 6)]
    return [Request(uid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                    max_new=max_new) for i, n in enumerate(lens)]


def phase_gemma2_path(dev, smi_line):
    """Full-width gemma2-27b (46 layers, local 4096-token windows beside
    global layers, softcap 50 and final softcap 30, tied embeddings) on the
    float ServeEngine: the scheduler over a page pool for the global layers
    and slot-private rings for the local ones, then generate()."""
    cfg = get_config("gemma2-27b")
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, max_len=GEMMA2_MAX_LEN, page_size=16,
                      device=dev)
    del params                      # the float32 embedding: the engine
    gc.collect()                    # keeps its rounded copy
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [eng.params["embed"], eng.params["ln_final"]]
                       + [w for part in eng.params["blocks"].values()
                          for w in (part.values() if isinstance(part, dict)
                                    else [part])])
    check(eng._sa["k"] == [-1, 4] and eng._sa["v"] == [-1, 4],
          f"gemma2 seq axes {eng._sa}: the local ring pages or the global "
          f"layer does not")
    crossed = []                     # slots past position 4096, per step
    decode = eng.decode_slots

    def tracked(cache, *a, **k):
        out = decode(cache, *a, **k)
        crossed.append(int((out[2]["len"] > 4096).sum()))
        return out
    eng.decode_slots = tracked
    sched = ContinuousBatchingScheduler(eng, max_slots=GEMMA2_SLOTS)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=64, max_new=4)
    reqs = gemma2_requests(cfg.vocab_size)
    clock.reset()
    crossed.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"not every request DONE: {out['by_state']}")
    check(all(r.gen_len == GEMMA2_NEW for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    # every prompt fits the ring: one block prefill, a flash launch per
    # layer; a decode step pages the 23 global layers only
    want = {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
            "paged_decode_attention": (L // 2) * steps, "rwkv6_scan": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    check(max(crossed) >= 2, f"the two long requests never decoded past "
          f"position 4096 together: {max(crossed)} slots did")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    stats = eng.cache_stats(sched.cache)
    first = [r.tokens.tolist() for r in res]
    again = sched.run(reqs)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    # generate(): one block prefill of 2 x 2,047 tokens, then 16 steps on
    # the dense cache (rings included), no paged launch
    gb, gt, gn = GEMMA2_GENERATE
    prompts = np.random.default_rng(SEED + 13).integers(
        1, cfg.vocab_size, (gb, gt)).astype(np.int32)
    ops.reset_launch_counts()
    g = eng.generate(prompts, max_new=gn)
    gen_counts = ops.launch_counts()
    check(gen_counts == {"w4a8_matmul": 0, "flash_attention": L,
                         "paged_decode_attention": 0, "rwkv6_scan": 0},
          f"generate() launch counts {gen_counts}")
    check(g["tokens"].shape == (gb, gn)
          and bool(((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()),
          "generate() tokens out of range")
    info = {"phase": "gemma2_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype,
            "window": cfg.layer_pattern[0].window, "softcap": cfg.softcap,
            "final_softcap": cfg.final_softcap,
            "max_slots": GEMMA2_SLOTS, "page_size": 16,
            "max_len": GEMMA2_MAX_LEN, "num_pages": eng._pager.pool.num_pages,
            "seq_axes": eng._sa, "requests": len(reqs), "all_done": True,
            "setup_s": setup_s, "weight_bytes": weight_bytes,
            "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "launches": counts, "launches_expected": want,
            "flash_per_prefill": counts["flash_attention"] / len(reqs),
            "paged_per_decode_step": counts["paged_decode_attention"] / steps,
            "most_slots_past_4096": max(crossed),
            "meter_bytes": meter, "second_run_identical": True,
            "cache": stats,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "generate": {"batch": gb, "prompt_len": gt, "max_new": gn,
                         "launches": gen_counts,
                         "prefill_s": g["prefill_s"],
                         "decode_s": g["decode_s"],
                         "decode_tokens_per_s": g["tokens_per_s"]},
            "peak_memory_bytes": peak, "setup_peak_memory_bytes": setup_peak,
            "card": smi_line}
    emit(info)
    return eng, info


# decode steps under torch.profiler in each path's profile phase, few to
# keep the script inside its time limit (the trace's processing grows with
# the steps' host ops)
PROFILE_STEPS = 3


def phase_profile(eng, dev, path, slots=8):
    """Device time by kernel over PROFILE_STEPS decode steps of a path with
    all its slots decoding, and the device's busy share of the host's wall
    time."""
    from torch.profiler import ProfilerActivity, profile
    sched = ContinuousBatchingScheduler(eng, max_slots=slots)
    sched.begin()
    for r in main_requests(eng.cfg.vocab_size, n=slots, max_new=40):
        sched.submit(r)
    while len(sched.decoding_uids()) < slots:
        sched.step()
    for _ in range(2):
        sched.step()
    torch.cuda.synchronize()
    n = PROFILE_STEPS
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    w4a8_calls = ops.launch_counts()["w4a8_matmul"]
    prof_info = {"phase": "profile", "path": path, "config": eng.cfg.name,
                 "slots": slots,
                 **profile_summary(prof, wall, n, path, w4a8_calls)}
    emit(prof_info)
    return prof_info


def profile_summary(prof, wall, n, path, w4a8_calls=0):
    """Per-step device time by kernel, the device's busy share of the
    host's wall time and the host ops of ``n`` profiled decode steps; a
    W4A8 call must be one device kernel."""
    rows = []
    dev_total, w4a8_kernels = 0.0, 0
    events = prof.key_averages()       # aggregated once: it walks every event
    for ev in events:
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue                   # host-side ops (their kernels count below)
        if "w4a8" in ev.key:
            w4a8_kernels += ev.count
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            dev_total += t
            rows.append((t, ev.key, ev.count))
    if w4a8_calls and dev_total:     # a session with no device activity
        check(w4a8_kernels == w4a8_calls, f"{path}: {w4a8_kernels} W4A8 device "
              f"kernels for {w4a8_calls} calls")
    rows.sort(reverse=True)
    host = sorted(((getattr(ev, "self_cpu_time_total", 0.0), ev.key, ev.count)
                   for ev in events
                   if not str(getattr(ev, "device_type", "")).endswith("CUDA")),
                  reverse=True)
    busy = dev_total / 1e6 / wall if wall else 0.0
    return {
        "decode_steps": n, "wall_ms_per_step": wall / n * 1e3,
        "device_ms_per_step": dev_total / 1e3 / n,
        "device_busy_share": busy if dev_total else "not measured",
        "w4a8_calls": w4a8_calls,
        "w4a8_device_kernels_per_call": (w4a8_kernels / w4a8_calls
                                         if w4a8_calls and dev_total
                                         else None),
        "top_kernels": [{"name": k[:80], "ms_per_step": t / 1e3 / n,
                         "calls_per_step": c / n} for t, k, c in rows[:12]],
        "host_ops_per_step": sum(c for _, _, c in host) / n,
        "top_host_ops": [{"name": k[:60], "self_cpu_ms_per_step": t / 1e3 / n,
                          "calls_per_step": c / n} for t, k, c in host[:12]]}


def w4a8_step_launches(eng, M, gen, dev):
    """The main path's W4A8 launches of one decode step at M slots, on the
    engine's real codes: 7 per layer plus the LM head."""
    mats = []
    for p in eng._layers:
        for w in (p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"],
                  p["attn"]["wo"], p["mlp"]["w1"], p["mlp"]["w3"], p["mlp"]["w2"]):
            mats.append(w)
    mats.append(eng._head)
    acts = {}
    for w in mats:
        K = w.codes.shape[0]
        if K not in acts:
            acts[K] = (torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                                     dtype=torch.int8),
                       torch.rand((M, 1), generator=gen, device=dev) * 0.01 + 1e-4)
    return [(acts[w.codes.shape[0]], w) for w in mats]


def w4a8_bound_ms(launches, code_bytes=0.5) -> float:
    """max(bytes / HBM rate, int8 operations / tensor peak) over the
    launches, the codes at ``code_bytes`` each (0.5: two per byte, as the
    kernel reads them; 1: one int8 per code, the bound before the packed
    layout)."""
    nbytes = ops_ = 0
    for (qx, xs), w in launches:
        (M, K), N = qx.shape, w.codes.shape[1]
        b, o = costs.w4a8(M, K, N, code_bytes)
        nbytes += b
        ops_ += o
    return max(nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S) * 1e3


def int_mm_yardstick(launches):
    """torch._int_mm on the same int8 operands (M padded to the 17 rows it
    requires) plus the same scale epilogue, one call per launch."""
    padded = []
    for (qx, xs), w in launches:
        M = qx.shape[0]
        qp = torch.zeros((17, qx.shape[1]), dtype=torch.int8, device=qx.device)
        qp[:M] = qx
        padded.append((qp, xs, w, M))

    def run():
        for qp, xs, w, M in padded:
            acc = torch._int_mm(qp, w.codes)[:M]
            (acc.float() * xs * w.scales).to(torch.bfloat16)
    return run


def graph_time_ms(fn, iters: int) -> float:
    """Device milliseconds of ``fn()``: captured once in a CUDA graph and
    replayed, so the host's launch overhead is out of the measurement (the
    eager loop on this path is host-bound; see the profile phase)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, iters)
    del graph
    return ms


def yardstick_ms(fn, iters, detail, name):
    """A library call's time; it is only a yardstick, so a call the card's
    PyTorch refuses is reported as null with its error."""
    try:
        return graph_time_ms(fn, iters)
    except RuntimeError as e:
        torch.cuda.synchronize()
        detail.append({name + "_error": str(e)[:300]})
        return None


def flex_softcap(softcap):
    """The one PyTorch call that computes softcapped attention:
    ``flex_attention`` compiled, as it is meant to run, with the score_mod
    ``softcap * tanh(s / softcap)`` on the scaled scores and GQA.  Returns
    ``fn(q, k, v, block_mask)``."""
    from torch.nn.attention.flex_attention import flex_attention
    compiled = torch.compile(flex_attention, dynamic=False)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    return lambda q, k, v, mask: compiled(q, k, v, score_mod=score_mod,
                                          block_mask=mask, enable_gqa=True)


def flex_mask(mask_mod, B, Tq, Tk, dev):
    from torch.nn.attention.flex_attention import create_block_mask
    return create_block_mask(mask_mod, B, None, Tq, Tk, device=dev)


def causal_mask_mod(window):
    """Query i sees key j when j <= i and, with a window, j > i - window
    (``ref.flash_attention``'s mask)."""
    def mask_mod(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        if window is not None:
            ok = ok & (kv_idx > q_idx - window)
        return ok
    return mask_mod


def phase_times(eng, dev, counts):
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kernels, detail = [], []
    # --- W4A8: one decode step's 155 launches of the 22-layer model at M = 8
    #     on the engine's codes (its MAIN_LAYERS layers' launches repeated
    #     to 22 layers' worth, then the head: 1.03 GB, so every launch reads
    #     its codes from HBM, as decode does)
    launches = w4a8_step_launches(eng, 8, gen, dev)
    full = get_config("tinyllama-1.1b").num_layers
    per_layer = launches[:-1] * -(-full // eng.cfg.num_layers)
    launches = per_layer[:7 * full] + launches[-1:]

    def w4a8_step(fn, ls):
        return lambda: [fn(qx, xs, w.codes, w.scales, packed=w.packed)
                        for (qx, xs), w in ls]

    def plain_step(ls):
        return lambda: [ref.w4a8_matmul(qx, xs, w.codes, w.scales)
                        for (qx, xs), w in ls]

    k_ms = graph_time_ms(w4a8_step(ops.w4a8_matmul, launches), iters=20)
    eager_ms = cuda_time_ms(w4a8_step(ops.w4a8_matmul, launches), iters=5)
    p_ms = graph_time_ms(plain_step(launches), iters=3)
    lib_ms = yardstick_ms(int_mm_yardstick(launches), 20, detail, "w4a8_library")
    # the head is one matrix: seven more of its shape (seeded random codes)
    # make a graph of eight launches, as the layers' shapes have 11-22, so
    # that no per-shape time is one replay's fixed cost
    K, N = eng._head.codes.shape
    heads = [eng._head] + [
        QuantizedLinear(c, eng._head.scales, kw.pack_codes(c))
        for c in (torch.randint(-7, 8, (K, N), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(7))]
    for M in (1, 8):
        per = w4a8_step_launches(eng, M, gen, dev)
        for (K, N) in W4A8_SHAPES:
            # the layers' distinct matrices of this shape (the 8 heads)
            same = [x for x in per if tuple(x[1].codes.shape) == (K, N)]
            if len(same) == 1:
                same = [(same[0][0], h) for h in heads]
            t = graph_time_ms(w4a8_step(ops.w4a8_matmul, same), iters=10)
            detail.append({"w4a8_M": M, "K": K, "N": N,
                           "plan": kw.launch_plan(M, N, K, kw._sm_count(0))
                           ._asdict(),
                           "kernel_us": t * 1e3 / len(same),
                           "bound_us": w4a8_bound_ms(same[:1]) * 1e3,
                           "bound_us_int8_codes":
                               w4a8_bound_ms(same[:1], code_bytes=1) * 1e3})
    kernels.append({"name": "w4a8_matmul", "route": "cuda", "source": W4A8_SRC[0],
                    "replaces": W4A8_SRC[1],
                    "launches": counts["w4a8_matmul"],
                    "unit": "one decode step of the 22-layer model: 155 "
                            "launches at M=8 on the engine's codes (its "
                            f"{eng.cfg.num_layers} layers' repeated), "
                            "CUDA-graph replay",
                    "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": w4a8_bound_ms(launches), "bound_by": "bytes",
                    "bound_ms_int8_codes": w4a8_bound_ms(launches, code_bytes=1),
                    "bound_note": "bound_ms reads the codes packed two per "
                                  "byte, as the kernel does; "
                                  "bound_ms_int8_codes one byte per code",
                    "library_ms": lib_ms,
                    "library_note": "torch._int_mm, M padded to 17, plus the "
                                    "same scale epilogue",
                    "eager_ms": eager_ms})
    # --- paged attention: one decode step's 22 launches of the 22-layer
    #     model (one per layer's pool slice) at 8 slots of the main path's
    #     lengths
    lens = [9, 24, 40, 47, 63, 70, 88, 95]
    t = paged_step_times(gen, dev, full, 32, 4, 64, 16, lens,
                         detail, "paged_library")
    kernels.append({"name": "paged_decode_attention", "route": "cuda",
                    "source": PAGED_SRC[0], "replaces": PAGED_SRC[1],
                    "launches": counts["paged_decode_attention"],
                    "unit": "one decode step: 22 launches, 8 slots, lengths "
                            f"{lens}, CUDA-graph replay",
                    **t, "library_note": "scaled_dot_product_attention on an "
                                    "already-gathered dense view (gather "
                                    "excluded)"})
    emit({"phase": "times", "detail": detail})
    return kernels


def dense_view(c):
    """A paged case's pool gathered through its table into dense (B, Hkv,
    S, D) bf16 K and V (dequantized for an int8 / fp8 pool), with the
    lengths' (B, 1, 1, S) mask: the library call's operands, made before
    it is timed.  Returns (q, K, V, mask)."""
    B, P = c["table"].shape
    _, ps, Hkv, D = c["k"].shape
    S = P * ps
    pid = c["table"].long()
    kd, vd = (ref._fetch_pages(c[x], pid) for x in ("k", "v"))
    if c.get("k_scale") is not None:
        kd = kd * c["k_scale"][pid][:, :, None, :, None]
        vd = vd * c["v_scale"][pid][:, :, None, :, None]
    kd = kd.to(torch.bfloat16).reshape(B, S, Hkv, D).transpose(1, 2)
    vd = vd.to(torch.bfloat16).reshape(B, S, Hkv, D).transpose(1, 2)
    mask = (torch.arange(S, device=kd.device)[None, :]
            < c["lens"][:, None])
    return c["q"], kd.contiguous(), vd.contiguous(), mask[:, None, None, :]


def paged_step_times(gen, dev, L, Hq, Hkv, D, P, lens, detail, name,
                     kv=None, **opts):
    """One decode step's L paged launches (one per layer's pool slice) at
    slots of the given lengths, with the kernel's ``opts`` (softcap) over a
    bf16 pool, or an int8 / fp8 one (``kv``) with its per-(page, KV head)
    scales: kernel (graph replay), eager and plain times, the bound, and
    SDPA on an already-gathered (and, for a quantized pool, already
    dequantized) dense view as the library call.  SDPA takes no softcap:
    with one, the library call is flex_attention on that view and SDPA's
    time stays beside it as ``sdpa_without_softcap_ms``."""
    ps, B = 16, len(lens)
    cases = [paged_inputs(gen, dev, qdtype=torch.bfloat16, B=B, Hq=Hq,
                          Hkv=Hkv, D=D, ps=ps, P=P, lens=lens, kv=kv)
             for _ in range(L)]

    def paged_step(fn):
        return lambda: [run_paged(c, fn, **opts) for c in cases]

    # the timed launches' own geometry (split_plan's chunks at this P and
    # B * Hkv) against the plain version, before any timing
    errs = [paged_error(c, out, **opts) for c, out in
            zip(cases, paged_step(ops.paged_decode_attention)())]
    detail.append({name.replace("_library", "") + "_vs_plain": {
        "chunk_pages_chunks": kpa.split_plan(ps, P, B * Hkv, D),
        "max_abs_err": max(e[0] for e in errs),
        "max_err_bf16_ulps": max(e[1] for e in errs)}})
    check(all(e[2] for e in errs), f"paged attention at the timed geometry "
          f"{detail[-1]} outside tolerance")
    k_ms = graph_time_ms(paged_step(ops.paged_decode_attention), iters=50)
    eager_ms = cuda_time_ms(paged_step(ops.paged_decode_attention), iters=10)
    p_ms = graph_time_ms(paged_step(ref.paged_decode_attention), iters=5)
    toks = sum(lens)
    # bytes the function must move: the live tokens' K and V (1-byte codes
    # plus both scale arrays' entries of the live pages for a quantized
    # pool), q in, out, the table and the lengths; operations: q.k and p.v
    # in f32
    live_pages = sum(-(-n // ps) for n in lens)
    b, f = costs.paged(B, Hq, Hkv, D, toks, P, live_pages, kv is not None)
    nbytes, flops = L * b, L * f
    dense = [dense_view(c) for c in cases]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = yardstick_ms(lambda: [sdpa(q, k, v, attn_mask=m,
                                         enable_gqa=True)
                                    for q, k, v, m in dense], 50, detail, name)
    out = {"ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                           flops / F32_FLOPS_PER_S) * 1e3,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / F32_FLOPS_PER_S else "operations"),
           "library_ms": sdpa_ms, "eager_ms": eager_ms}
    if opts.get("softcap"):
        # SDPA takes no softcap: the library call is flex_attention on the
        # same dense view, masked to each slot's live length
        lens_t = cases[0]["lens"]
        mask = flex_mask(lambda b, h, q_idx, kv_idx: kv_idx < lens_t[b],
                         B, 1, P * ps, dev)
        flex = flex_softcap(opts["softcap"])
        q, kd, vd, _ = dense[0]
        detail.append({name.replace("_library", "") + "_flex_vs_plain": float(
            (flex(q, kd, vd, mask).float() - ref.paged_decode_attention(
                q, cases[0]["k"], cases[0]["v"], cases[0]["table"], lens_t,
                **opts).float()).abs().max())})
        out["library_ms"] = yardstick_ms(
            lambda: [flex(q, k, v, mask) for q, k, v, _ in dense], 50,
            detail, name)
        out["sdpa_without_softcap_ms"] = sdpa_ms
    return out


def phase_times_kv(dev, serve_info, feat_info):
    """The paged kernel at llama2-7b's decode shape over an int8 pool and an
    fp8 pool (32 launches, 8 slots at the serve path's lengths 16 tokens
    into their decode), as features_path's quantized runs call it."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    detail, rows = [], {}
    lens = [n - 1 + 16 for n in serve_info["prompt_lens"][:8]]
    for kv, run in (("int8", "c_int8_prefix_on"), ("fp8", "d_fp8_prefix_on")):
        t = paged_step_times(gen, dev, 32, 32, 32, 128, FEATURE_LEN // 16,
                             lens, detail, f"paged_llama2_{kv}_library",
                             kv=kv)
        t["unit"] = (f"one decode step of llama2-7b over an {kv} pool: 32 "
                     f"launches, 8 slots, 32/32 heads, D 128, lengths "
                     f"{lens}, per-(page, KV head) f32 scales, CUDA-graph "
                     "replay")
        t["launches_per_run"] = feat_info["runs"][run]["launches"][
            "paged_decode_attention"]
        t["bound_note"] = ("1-byte codes of the live tokens plus the live "
                           "pages' k and v scales")
        t["library_note"] = ("scaled_dot_product_attention on the already "
                             "gathered and dequantized bf16 view (gather "
                             "and dequantization excluded)")
        rows[kv] = t
    emit({"phase": "times", "path": "features_path",
          "paged_llama2_int8": rows["int8"], "paged_llama2_fp8": rows["fp8"],
          "detail": detail})
    return rows


def flash_bound(launches, causal=True, windows=None):
    """(ms, "bytes" or "operations"): max(bytes / HBM rate, flops / bf16
    tensor peak) over the launches, with q, out, k and v each moved once
    and 4 * D flops per visible q-k pair: causal, query i sees
    min(i + 1, window) keys (``windows``: each launch's window or None)."""
    nbytes = flops = 0
    for (q, k, _), w in zip(launches, windows or [None] * len(launches)):
        B, Hq, Tq, D = q.shape
        b, f = costs.flash(B, Hq, k.shape[1], Tq, k.shape[2], D,
                           q.element_size(), causal, w)
        nbytes += b
        flops += f
    return costs.bound_ms(nbytes, flops, BF16_FLOPS_PER_S)


def phase_times_serve(dev, serve_info):
    """The serve path's kernels: the flash kernel over one 512-token
    prefill's 32 launches at llama2-7b's shape, and the paged kernel over
    one decode step's 32 launches at the serve path's lengths."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    detail = []
    L, T = 32, 512
    bf = torch.bfloat16
    launches = [flash_inputs(gen, dev, 1, 32, 32, T, T, 128, bf)
                for _ in range(L)]

    def prefill(fn, ls):
        return lambda: [fn(q, k, v, causal=True) for q, k, v in ls]

    k_ms = graph_time_ms(prefill(ops.attention, launches), iters=10)
    eager_ms = cuda_time_ms(prefill(ops.attention, launches), iters=3)
    p_ms = graph_time_ms(prefill(ref.flash_attention, launches), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = yardstick_ms(
        lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True)
                 for q, k, v in launches], 10, detail, "flash_library")
    for t in (64, 128, 256, 512):
        one = [[x[:, :, :t].contiguous() for x in launches[0]]]
        us = graph_time_ms(prefill(ops.attention, one), iters=20) * 1e3
        detail.append({"flash_T": t, "kernel_us": us,
                       "bound_us": flash_bound(one)[0] * 1e3})
    counts = serve_info["launches"]
    bound_ms, bound_by = flash_bound(launches)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": FLASH_SRC[0], "replaces": FLASH_SRC[1],
             "launches": counts["flash_attention"],
             "unit": "one 512-token prefill of llama2-7b: 32 launches, "
                     "B 1, 32/32 heads, D 128, causal, bf16, CUDA-graph "
                     "replay",
             "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms,
             "library_note": "scaled_dot_product_attention(is_causal=True, "
                             "enable_gqa=True) on the same tensors",
             "eager_ms": eager_ms}
    # paged at llama2-7b's decode shape: 8 slots at the serve path's
    # prompt lengths, 16 tokens into their decode
    lens = [n - 1 + 16 for n in serve_info["prompt_lens"][:8]]
    paged = paged_step_times(gen, dev, L, 32, 32, 128, 1024 // 16, lens,
                             detail, "paged_llama2_library")
    paged["unit"] = ("one decode step of llama2-7b: 32 launches, 8 slots, "
                     f"32/32 heads, D 128, lengths {lens}, CUDA-graph replay")
    emit({"phase": "times", "path": "serve_path", "flash": flash,
          "paged_llama2": paged, "detail": detail})
    emit({"info": "times before the redesign, from PERF.md; NOT measured "
                  "in this run", **BEFORE_REDESIGN})
    return flash, paged


FLEX_NOTE = ("torch.nn.attention.flex_attention under torch.compile, "
             "score_mod 50 * tanh(s / 50), enable_gqa, CUDA-graph replay, "
             "{}; sdpa_without_softcap_ms is scaled_dot_product_attention "
             "without the softcap, another function of the same shape")


def phase_times_gemma2(dev, info):
    """gemma2-27b's kernels at gemma2_path's shapes: the flash kernel over
    one 4,084-token prefill's 46 launches (23 local layers with the
    4096-token window, 23 global; softcap 50), and the paged kernel over
    one decode step's 23 global-layer launches at 4 slots of the path's
    lengths, 16 tokens into their decode."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    detail = []
    cfg = get_config("gemma2-27b")
    L, T = cfg.num_layers, max(info["prompt_lens"]) - 1
    bf = torch.bfloat16
    windows = [cfg.layer_pattern[j % 2].window for j in range(L)]
    launches = [flash_inputs(gen, dev, 1, 32, 16, T, T, 128, bf)
                for _ in range(L)]

    def prefill(fn, ls):
        return lambda: [fn(q, k, v, causal=True, window=w, softcap=50.0)
                        for (q, k, v), w in zip(ls, windows)]

    k_ms = graph_time_ms(prefill(ops.attention, launches), iters=5)
    eager_ms = cuda_time_ms(prefill(ops.attention, launches), iters=2)
    p_ms = cuda_time_ms(prefill(ref.flash_attention, launches), iters=1,
                        warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = yardstick_ms(
        lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True)
                 for q, k, v in launches], 5, detail, "flash_gemma2_sdpa")
    flex = flex_softcap(50.0)
    masks = {w: flex_mask(causal_mask_mod(w), None, T, T, dev)
             for w in set(windows)}
    for (q, k, v), w in list(zip(launches, windows))[:2]:   # local, global
        detail.append({"flash_gemma2_flex_vs_plain": float(
            (flex(q, k, v, masks[w]).float() - ref.flash_attention(
                q, k, v, causal=True, window=w, softcap=50.0).float())
            .abs().max()), "window": w})
    lib_ms = yardstick_ms(
        lambda: [flex(q, k, v, masks[w])
                 for (q, k, v), w in zip(launches, windows)], 5, detail,
        "flash_gemma2_library")
    bound_ms, bound_by = flash_bound(launches, windows=windows)
    flash = {"unit": f"one {T}-token prefill of gemma2-27b: {L} launches, "
                     "B 1, 32/16 heads, D 128, causal, softcap 50, window "
                     "4096 on every other layer, bf16, CUDA-graph replay; "
                     "plain timed eagerly",
             "launches_per_prefill": info["flash_per_prefill"],
             "ms": k_ms, "eager_ms": eager_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms, "sdpa_without_softcap_ms": sdpa_ms,
             "library_note": FLEX_NOTE.format(
                 "block mask causal with the 4096 window on the local "
                 "layers")}
    lens = [n - 1 + 16 for n in info["prompt_lens"][:GEMMA2_SLOTS]]
    paged = paged_step_times(gen, dev, L // 2, 32, 16, 128,
                             GEMMA2_MAX_LEN // 16, lens, detail,
                             "paged_gemma2_library", softcap=50.0)
    paged["unit"] = (f"one decode step of gemma2-27b: {L // 2} launches "
                     f"(the global layers), {GEMMA2_SLOTS} slots, 32/16 "
                     f"heads, D 128, softcap 50, lengths {lens}, CUDA-graph "
                     "replay")
    paged["launches_per_step"] = info["paged_per_decode_step"]
    paged["library_note"] = FLEX_NOTE.format(
        "on the already-gathered dense view (gather excluded), block mask "
        "each slot's length")
    emit({"phase": "times", "path": "gemma2_path", "flash_gemma2": flash,
          "paged_gemma2": paged, "detail": detail})
    return flash, paged


def rwkv_bound(B, H, T, D, itemsize, launches=1):
    """(ms, "bytes" or "operations"): max(bytes / HBM rate, flops / f32
    peak) with r, k, v, w read once, out written once, the f32 final state
    written once, and the 5 D^2 f32 operations per (b, h, t) that the
    function needs: 3 D^2 for the update w S + k v, 2 D^2 for sum_i r_i
    S_ij (the bonus term v_j sum_i r_i u_i k_i is O(D), left out)."""
    b, f = costs.rwkv(B, H, T, D, itemsize)
    return costs.bound_ms(launches * b, launches * f, F32_FLOPS_PER_S)


def phase_times_rwkv(dev, rwkv_info):
    """The scan kernel over one full-width forward's 32 launches at the
    path's shape (B 4, H 64, T 512, D 64, bf16), each on its own inputs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16
    L = 32
    launches = [rwkv_inputs(gen, dev, *RWKV_FWD, bf, "model") for _ in range(L)]

    def fwd(fn, ls):
        return lambda: [fn(*a) for a in ls]

    k_ms = graph_time_ms(fwd(ops.rwkv6, launches), iters=10)
    eager_ms = cuda_time_ms(fwd(ops.rwkv6, launches), iters=3)
    p_ms = cuda_time_ms(fwd(ref.rwkv6_scan, launches), iters=1, warmup=1)
    detail = []
    for B, T in ((1, 512), (4, 37), (4, 1)):
        one = [[a[:B, :, :T].contiguous() if a.dim() == 4 else a
                for a in launches[0]]]
        detail.append({"rwkv_B": B, "T": T,
                       "kernel_us": graph_time_ms(fwd(ops.rwkv6, one),
                                                  iters=20) * 1e3,
                       "bound_us": rwkv_bound(B, 64, T, 64, 2)[0] * 1e3})
    bound_ms, bound_by = rwkv_bound(*RWKV_FWD, 2, launches=L)
    kern = {"name": "rwkv6_scan", "route": "cuda", "source": RWKV_SRC[0],
            "replaces": RWKV_SRC[1],
            "launches": rwkv_info["launches"]["rwkv6_scan"],
            "unit": "one rwkv6-7b forward of 4 x 512 tokens: 32 launches, "
                    "B 4, H 64, T 512, D 64, bf16, CUDA-graph replay; plain "
                    "timed eagerly (one call of 32 launches)",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_note": "none: no single PyTorch call computes the WKV "
                            "recurrence",
            "eager_ms": eager_ms}
    emit({"phase": "times", "path": "rwkv_path", "rwkv6_scan": kern,
          "detail": detail})
    return kern


# ----------------------------------------------------------------- chaos
NEAR_TIE_ULPS = 4          # a recomputed pick may differ only this close


def first_divergence(clean, got):
    """The first index where ``got`` differs from ``clean`` (over their
    common length), or None."""
    for i, (a, b) in enumerate(zip(clean, got)):
        if a != b:
            return i
    return None


def tie_report(logits_fn, prompt, clean, got):
    """Where a faulted request's tokens leave the fault-free run's: the
    logits at that position, computed by the engine's own path from the
    prompt and the common prefix (``logits_fn``), the gap between the two
    picks and whether it is a near-tie (within NEAR_TIE_ULPS bf16 ulps of
    the largest |logit|).  None where the tokens agree."""
    i = first_divergence(clean, got)
    if i is None:
        return None
    ctx = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(clean[:i], np.int32)])
    logits = logits_fn(ctx).float().cpu()
    a, b = int(clean[i]), int(got[i])
    gap = abs(logits[a].item() - logits[b].item())
    tol = NEAR_TIE_ULPS * bf16_ulp_of(logits.abs().max().item())
    return {"position": i, "clean": a, "faulted": b, "gap": gap,
            "tolerance": tol, "near_tie": gap <= tol}


def serve_logits_fn(eng):
    """A ServeEngine's logits after a context: the block prefill of all but
    its last token (flash on the card), then one decode step, as a
    re-admitted request computes them."""
    def fn(ctx):
        cfg = eng.cfg
        cache = api.init_cache(cfg, 1, len(ctx), device=eng.device)
        toks = torch.as_tensor(ctx[None, :], device=eng.device)
        if len(ctx) > 1:
            _, cache = api.prefill(eng.params, cache, toks[:, :-1], cfg)
        logits, _ = api.decode_step(eng.params, cache, toks[:, -1], cfg)
        return logits[0]
    return fn


def splitbrain_logits_fn(eng):
    """The split-brain engine's logits after a context: its B=1 token steps
    over all but the last token (``prefill_slot``), then one token step."""
    def fn(ctx):
        cache, tok = eng.prefill_slot(ctx)
        _, logits, _ = eng.decode_token(cache, [tok])
        return logits[0]
    return fn


def run_with_faults(eng, reqs, plan, seed=SEED, max_slots=8, **kw):
    """Serve ``reqs`` under a seeded fault plan, one iteration at a time:
    the pool must be empty the instant each recovering iteration ends.
    Returns (scheduler, its results, its counters, the injector, the
    engine's PhaseClock over the run)."""
    inj = FaultInjector(FaultPlan(**plan), seed=seed)
    sched = ContinuousBatchingScheduler(eng, max_slots=max_slots,
                                        faults=inj, **kw)
    clock = PhaseClock(eng)
    sched.begin()
    for r in reqs:
        sched.submit(r)
    seen = 0
    while sched.has_work():
        sched.step()
        if sched._recoveries > seen:
            seen = sched._recoveries
            pool = eng._pager.pool
            check((pool.pages_in_use, pool.total_reserved) == (0, 0),
                  f"pages survived the pool rebuild: {pool.pages_in_use}")
        check(sched._iterations < 5000, "a faulted run did not drain")
    torch.cuda.synchronize()
    PhaseClock.detach(eng)
    results = sorted(sched.poll(), key=lambda r: r.uid)
    stats = {"steps": sched._decode_steps,
             "prefill_tokens": sched._prefill_tokens,
             "decoded_tokens": sched._decoded_tokens,
             "recoveries": sched._recoveries,
             "quarantines": sched._quarantines,
             "failed": sched._failed_count,
             "preemptions": sched._preempt_count}
    return sched, results, stats, inj, clock


def hold_faulted(results, reqs, clean, logits_fn, name):
    """Every request DONE (or CANCELLED by the burst, with a prefix of its
    output); its tokens the fault-free run's, or leaving them only at a
    near-tie.  Returns the tie reports."""
    ties = []
    prompts = {r.uid: r.prompt for r in reqs}
    for r in results:
        check(r.state in ("DONE", "CANCELLED"),
              f"{name}: request {r.uid} ended {r.state}")
        want = clean[r.uid]
        got = r.tokens.tolist()
        if r.state == "DONE":
            check(len(got) == len(want), f"{name}: {r.uid} stopped short")
        rep = tie_report(logits_fn, prompts[r.uid], want, got)
        if rep is not None:
            rep["uid"] = r.uid
            ties.append(rep)
            check(rep["near_tie"], f"{name}: request {r.uid} left the "
                  f"fault-free tokens at a pick that is no near-tie: {rep}")
    return ties


CHAOS_SPLIT_PLAN = dict(step_corrupt_at=12, step_corrupt_iters=2,
                        step_corrupt_frac=0.25, step_error_at=24,
                        step_error_count=1, device_loss_at=40,
                        cancel_burst_at=56, cancel_burst_frac=0.25)
CHAOS_SERVE_PLAN = dict(step_corrupt_at=6, step_corrupt_iters=2,
                        step_corrupt_frac=0.5, device_loss_at=18)
CHAOS_SERVE_REQUESTS = 6


def phase_chaos_splitbrain(eng, main_info, smi_line):
    """chaos_path (a): main_path's tinyllama split-brain engine, reused, on
    main_path's 16 requests under a seeded plan with a transient NaN
    corruption, a step error, a device loss and a cancellation burst."""
    cfg = eng.cfg
    L = cfg.num_layers
    reqs = main_requests(cfg.vocab_size)
    clean = {r.uid: t for r, t in zip(reqs, main_info["_tokens"])}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched, res, st, inj, clock = run_with_faults(eng, reqs,
                                                 CHAOS_SPLIT_PLAN)
    decode_s = clock.decode_s
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    fired = {k: inj.fired(k) for k in ("step_corrupt", "step_error",
                                        "device_loss", "cancel_burst")}
    check(all(fired.values()), f"chaos (a): a planned fault never fired "
          f"{fired}")
    check(st["recoveries"] == 2 and st["failed"] == 0
          and st["quarantines"] >= 1, f"chaos (a): {st}")
    check(sum(r.state == "CANCELLED" for r in res) == fired["cancel_burst"],
          "chaos (a): the cancelled requests are not the burst's")
    want = {"w4a8_matmul": (7 * L + 1) * (st["prefill_tokens"] + st["steps"]),
            "paged_decode_attention": L * st["steps"], "flash_attention": 0,
            "rwkv6_scan": 0}
    check(counts == want, f"chaos (a) launch counts {counts} != {want}")
    ties = hold_faulted(res, reqs, clean, splitbrain_logits_fn(eng),
                        "chaos (a)")
    info = {"run": "a_splitbrain_tinyllama", "config": cfg.name,
            "plan": CHAOS_SPLIT_PLAN, "fired": fired,
            "by_state": {s: sum(r.state == s for r in res)
                         for s in ("DONE", "CANCELLED")},
            **st, "launches": counts, "launches_expected": want,
            "recovery_s": [e["recovery_s"] for e in sched.recovery_log
                           if e["event"] == "recover"],
            "events": [(e["event"], e.get("uid"), e["iteration"])
                       for e in sched.recovery_log],
            "identical_to_fault_free": sum(
                r.tokens.tolist() == clean[r.uid][:len(r.tokens)]
                for r in res),
            "near_ties": ties, "wall_s": wall, "decode_s": decode_s,
            "decode_steps_per_s": st["steps"] / decode_s,
            "clean_decode_steps_per_s": main_info["decode_steps_per_s"],
            "card": smi_line}
    return info


def phase_chaos_serve(eng, serve_info, smi_line):
    """chaos_path (b)-(d) on serve_path's llama2-7b ServeEngine, reused: (b)
    6 of its requests under a transient corruption and a device loss
    against a fault-free run of the same requests; (c) priority classes
    with preemption and a deadline; (d) the OnlineServer with a watchdog
    and a decode step wedged for longer than it."""
    cfg = eng.cfg
    L = cfg.num_layers
    reqs = serve_requests(cfg.vocab_size)[:CHAOS_SERVE_REQUESTS]
    logits_fn = serve_logits_fn(eng)
    # --- the fault-free run of the same requests
    clock = PhaseClock(eng)
    torch.cuda.synchronize()
    out = ContinuousBatchingScheduler(eng, max_slots=8).run(reqs)
    torch.cuda.synchronize()
    PhaseClock.detach(eng)
    clean = {r.uid: r.tokens.tolist() for r in out["results"]}
    clean_rate = out["steps"] / clock.decode_s
    # --- (b) corruption and device loss
    ops.reset_launch_counts()
    sched, res, st, inj, clock = run_with_faults(eng, reqs,
                                                 CHAOS_SERVE_PLAN)
    decode_s, prefills = clock.decode_s, clock.calls["prefill_slot"]
    counts = ops.launch_counts()
    fired = {k: inj.fired(k) for k in ("step_corrupt", "device_loss")}
    check(all(fired.values()), f"chaos (b): a planned fault never fired "
          f"{fired}")
    check(st["recoveries"] == 1 and st["failed"] == 0
          and st["quarantines"] >= 1, f"chaos (b): {st}")
    want = {"w4a8_matmul": 0, "flash_attention": L * prefills,
            "paged_decode_attention": L * st["steps"], "rwkv6_scan": 0}
    check(counts == want, f"chaos (b) launch counts {counts} != {want}")
    ties_b = hold_faulted(res, reqs, clean, logits_fn, "chaos (b)")
    check(all(r.state == "DONE" for r in res), "chaos (b): not all DONE")
    run_b = {"run": "b_serve_llama2", "config": cfg.name,
             "plan": CHAOS_SERVE_PLAN, "fired": fired, **st,
             "prefills": prefills, "launches": counts,
             "launches_expected": want,
             "recovery_s": [e["recovery_s"] for e in sched.recovery_log
                            if e["event"] == "recover"],
             "events": [(e["event"], e.get("uid"), e["iteration"])
                        for e in sched.recovery_log],
             "identical_to_fault_free": sum(r.tokens.tolist() == clean[r.uid]
                                            for r in res),
             "near_ties": ties_b, "decode_s": decode_s,
             "decode_steps_per_s": st["steps"] / decode_s,
             "clean_decode_steps_per_s": clean_rate}
    totals = dict(counts)
    # --- (c) priorities, preemption and a deadline on two slots
    ops.reset_launch_counts()
    sched = ContinuousBatchingScheduler(eng, max_slots=2, preemption=True,
                                        backoff_steps=1)
    sched.begin()
    for r in reqs[:2]:
        sched.submit(Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                             priority=0))
    while len(sched.decoding_uids()) < 2:
        sched.step()
    for _ in range(4):
        sched.step()
    sched.submit(Request(uid=reqs[2].uid, prompt=reqs[2].prompt,
                         max_new=reqs[2].max_new, priority=5))
    sched.submit(Request(uid=reqs[3].uid, prompt=reqs[3].prompt,
                         max_new=reqs[3].max_new, priority=0,
                         deadline_s=sched.clock() + 0.05))
    while sched.has_work():
        sched.step()
        check(sched._iterations < 2000, "chaos (c) did not drain")
    torch.cuda.synchronize()
    res_c = sorted(sched.poll(), key=lambda r: r.uid)
    states = {r.uid: r.state for r in res_c}
    check(states == {reqs[0].uid: "DONE", reqs[1].uid: "DONE",
                     reqs[2].uid: "DONE", reqs[3].uid: "TIMEOUT"},
          f"chaos (c): states {states}")
    pre = {r.uid: r.preemptions for r in res_c}
    check(pre[reqs[2].uid] == 0 and pre[reqs[0].uid] + pre[reqs[1].uid] >= 1,
          f"chaos (c): preemptions {pre}")
    ties_c = hold_faulted([r for r in res_c if r.state == "DONE"], reqs,
                          clean, logits_fn, "chaos (c)")
    run_c = {"run": "c_priorities_preemption_deadline",
             "states": states, "preemptions": pre,
             "launches": ops.launch_counts(),
             "identical_to_fault_free": sum(
                 r.tokens.tolist() == clean[r.uid] for r in res_c
                 if r.state == "DONE"),
             "near_ties": ties_c}
    for k, v in run_c["launches"].items():
        totals[k] += v
    # --- (d) the OnlineServer's watchdog, after a warm-up
    stall_s, watchdog_s = 5.0, 2.0
    inj = FaultInjector(FaultPlan(step_stall_at=8, step_stall_s=stall_s),
                        seed=SEED)
    stalled = []
    stall = inj.step_stall

    def timed_stall():
        if not inj._step_stalled and inj.iteration >= 8:
            stalled.append(time.monotonic())
        stall()
    inj.step_stall = timed_stall
    # warm up before the watchdog is armed, on a scheduler of its own (the
    # injector counts its scheduler's iterations)
    ContinuousBatchingScheduler(eng, max_slots=8).warmup(prompt_len=64,
                                                         max_new=4)
    sched = ContinuousBatchingScheduler(eng, max_slots=8, faults=inj)
    srv = OnlineServer(sched, watchdog_s=watchdog_s)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    tripped = None
    with srv:
        handles = [srv.submit(r.prompt, max_new=r.max_new) for r in reqs[:4]]
        while not all(h.done() for h in handles):
            if tripped is None and srv._watchdog_trips:
                tripped = time.monotonic()
            time.sleep(0.01)
            check(time.monotonic() - t0 < 300, "chaos (d): the server hung")
        results = [h.result() for h in handles]
    wall = time.monotonic() - t0
    stats = srv.stats()
    check(inj.fired("step_stall") == 1 and stats["watchdog_trips"] >= 1
          and stats["recoveries"] >= 1 and tripped is not None and stalled,
          f"chaos (d): the watchdog did not trip: {stats}")
    for r, q in zip(results, reqs[:4]):
        r.uid = q.uid            # the server numbers its own requests
    ties_d = hold_faulted(results, reqs, clean, logits_fn, "chaos (d)")
    check(all(r.state == "DONE" for r in results), "chaos (d): not all DONE")
    run_d = {"run": "d_online_server_watchdog", "watchdog_s": watchdog_s,
             "step_stall_s": stall_s,
             "trip_after_stall_s": tripped - stalled[0],
             "stats": stats, "wall_s": wall, "launches": ops.launch_counts(),
             "identical_to_fault_free": sum(
                 r.tokens.tolist() == clean[r.uid] for r in results),
             "near_ties": ties_d}
    for k, v in run_d["launches"].items():
        totals[k] += v
    return [run_b, run_c, run_d], totals


# ----------------------------------------------------------------- hymba
HYMBA_SLOTS, HYMBA_MAX_LEN, HYMBA_NEW, HYMBA_PAGE = 8, 512, 32, 16
HYMBA_FWD = (2, 2048)
# hymba_path runs 8 of the 32 layers at full width (cut when moe_path
# joined, to keep the script inside its time limit: the per-token prefill
# and the sequential scan make its time grow with the depth); its kernels'
# times phase keeps the full 32-layer forward and decode step as units
HYMBA_LAYERS = 8


def hymba_requests(vocab, n=8, max_new=HYMBA_NEW):
    rng = np.random.default_rng(SEED + 15)
    return [Request(uid=i, prompt=rng.integers(1, vocab, int(rng.integers(
        32, 129))).astype(np.int32), max_new=max_new) for i in range(n)]


def phase_reference_hymba(dev):
    """Reduced hymba-1.5b on the card and on the CPU from the same weights,
    on the ring layout (max_len 40: the 16-token ring wraps) and the paged
    one (max_len 12, page 4: K/V page, the SSM state stays dense), under
    the scheduler; and forward.  The card's tokens, fed back teacher-forced
    through the decode steps on both devices, give float32 logits within
    two bf16 ulps of the largest, a pick the CPU would not make is a
    near-tie; forward's logits within one bf16 ulp of the largest."""
    cfg = get_config("hymba-1.5b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rows = []
    for layout, kw, lens, max_len in (
            ("ring", dict(), (5, 9, 17, 24, 30), 40),
            ("paged", dict(page_size=4), (3, 5, 2, 7, 4), 12)):
        reqs = [Request(uid=i, prompt=(np.arange(1, n + 1) * 7 % 256)
                        .astype(np.int32), max_new=4)
                for i, n in enumerate(lens)]
        engs = {str(d): ServeEngine(cfg, params, max_len=max_len, device=d,
                                    **kw) for d in ("cpu", dev)}
        toks = {d: [r.tokens.tolist() for r in ContinuousBatchingScheduler(
            e, max_slots=2).run(reqs)["results"]] for d, e in engs.items()}
        seqs = [(q.prompt, np.asarray(t, np.int32))
                for q, t in zip(reqs, toks[str(dev)])]
        tf = {d: torch.cat([teacher_forced_logits(e.params, cfg, p, t, d)
                            for p, t in seqs]) for d, e in engs.items()}
        rep = pick_report(tf["cpu"], tf[str(dev)],
                          np.concatenate([t for _, t in seqs]))
        rep["tolerance"] = 2 * bf16_ulp_of(rep["max_abs_logit"])
        rep["tokens_identical"] = toks["cpu"] == toks[str(dev)]
        check(rep["max_abs_err"] <= rep["tolerance"]
              and rep["shortfall"] <= 2 * rep["tolerance"],
              f"reduced hymba {layout}: card vs CPU {rep}")
        rows.append({"layout": layout, **rep})
    toks = torch.from_numpy(np.stack([(np.arange(1, 41) * (3 + i)) % 256
                                      for i in range(2)]).astype(np.int32))
    fwd = {d: api.forward(e.params, toks.to(d), cfg)[0]
           .reshape(-1, cfg.vocab_size).cpu() for d, e in engs.items()}
    rep = pick_report(fwd["cpu"], fwd[str(dev)], fwd[str(dev)].argmax(-1))
    rep["tolerance"] = bf16_ulp_of(rep["max_abs_logit"])
    check(rep["max_abs_err"] <= rep["tolerance"]
          and rep["shortfall"] <= 2 * rep["tolerance"],
          f"reduced hymba forward: card vs CPU {rep}")
    exp_x = torch.cat([torch.rand(1 << 20, generator=torch.Generator()
                                  .manual_seed(SEED)) * -100.0])
    check(torch.equal(ref.exp(exp_x.to(dev)).cpu(), ref.exp(exp_x)),
          "ref.exp (XLA's exp) differs between the card and the CPU")
    emit({"phase": "reference_hymba", "config": cfg.name, "serve": rows,
          "forward": rep, "xla_exp_card_equals_cpu": True,
          "tolerance": "serve, teacher-forced: 2 bf16 ulps of the largest "
                       "|logit|, a pick the CPU would not make short of "
                       "its largest by at most twice that; forward: 1 ulp"})


def phase_hymba_path(dev, smi_line):
    """Full-width hymba-1.5b at HYMBA_LAYERS of its 32 layers (d_model
    1600, 25/5 heads of 64, window 1024, SSM state 16; float32 weights from
    a seeded generator on the card): api.forward on 2 x 2,048 tokens twice
    (one flash launch per layer per call, each layer's attention held
    against the plain version), then the
    float ServeEngine on a paged pool (K/V page: max_len 512 plus a page is
    inside the window; the SSM state stays a dense slot leaf) under the
    scheduler with 8 slots."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              num_layers=HYMBA_LAYERS)
    L = cfg.num_layers
    window = cfg.layer_pattern[0].window
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [params["embed"], params["lm_head"]]
                      + [w for part in params["blocks"].values()
                         for w in (part.values() if isinstance(part, dict)
                                   else [part])])
    eng = ServeEngine(cfg, params, max_len=HYMBA_MAX_LEN,
                      page_size=HYMBA_PAGE, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    check(eng._sa == {"k": 3, "v": 3, "ssm": -1, "len": -1},
          f"hymba seq axes {eng._sa}: K/V should page, the SSM state not")
    # --- forward on 2 x 2,048 tokens (past the window), twice
    B, T = HYMBA_FWD
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 16))
    zero = {name: 0 for name in ops.KERNELS}
    recorded, attention = [], ops.attention

    def recording(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        recorded.append((q, k, v, kw, out))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runs = []
    for i in range(2):
        ops.attention = recording if i == 0 else attention
        try:
            before = ops.launch_counts()
            t = time.perf_counter()
            logits, _ = api.forward(eng.params, toks, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            ops.attention = attention
        after = ops.launch_counts()
        check({k: after[k] - before[k] for k in after}
              == {**zero, "flash_attention": L},
              f"hymba forward launch counts {before} -> {after}: not {L}")
        runs.append((logits, dt))
    fwd_counts = ops.launch_counts()
    fwd_peak = torch.cuda.max_memory_allocated()
    (l1, dt1), (l2, dt2) = runs
    check(l1.shape == (B, T, cfg.vocab_size) and l1.dtype == torch.float32
          and bool(torch.isfinite(l1).all()),
          "hymba forward logits not finite or of the wrong shape")
    check(torch.equal(l1, l2), "a second hymba forward gave other logits")
    fwd_max = l1.abs().max().item()
    del runs, l1, l2, logits
    check(len(recorded) == L and all(
        kw == dict(causal=True, window=window, softcap=None)
        and tuple(q.shape) == (B, cfg.num_heads, T, 64)
        and tuple(k.shape) == (B, cfg.num_kv_heads, T, 64)
        for q, k, _, kw, _ in recorded), "hymba forward attention shapes")
    attn_err = 0.0
    for q, k, v, kw, out in recorded:
        plain = ref.flash_attention(q, k, v, **kw)
        diff = (out.float() - plain.float()).abs()
        tol = bf16_ulp(plain.float()) + 1e-5
        check(bool((diff <= tol).all()), "hymba forward: a layer's flash "
              f"attention outside tolerance ({diff.max().item()})")
        attn_err = max(attn_err, diff.max().item())
    del recorded, plain
    # --- serving: 8 requests (32-128 prompt tokens, per-token prefill)
    sched = ContinuousBatchingScheduler(eng, max_slots=HYMBA_SLOTS)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=32, max_new=4)
    reqs = hymba_requests(cfg.vocab_size)
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"hymba: not every request DONE: {out['by_state']}")
    check(all(r.gen_len == HYMBA_NEW for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    want = {"w4a8_matmul": 0, "flash_attention": 0,
            "paged_decode_attention": L * steps, "rwkv6_scan": 0}
    check(counts == want, f"hymba serve launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    stats = eng.cache_stats(sched.cache)
    info = {"phase": "hymba_path", "config": cfg.name, "layers": L,
            "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "ssm_state": cfg.ssm.state_dim,
            "window": window, "dtype": cfg.dtype,
            "param_bytes_f32": param_bytes, "setup_s": setup_s,
            "setup_peak_memory_bytes": setup_peak,
            "forward": {"batch": B, "tokens": T, "launches": fwd_counts,
                        "seconds": [dt1, dt2], "tokens_per_s": B * T / dt2,
                        "max_abs_logit": fwd_max, "second_identical": True,
                        "attention_vs_plain_max_abs_err": attn_err,
                        "peak_memory_bytes": fwd_peak},
            "max_slots": HYMBA_SLOTS, "page_size": HYMBA_PAGE,
            "max_len": HYMBA_MAX_LEN, "num_pages": eng._pager.pool.num_pages,
            "seq_axes": eng._sa, "requests": len(reqs), "all_done": True,
            "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "serve_launches": counts, "launches_expected": want,
            "paged_per_decode_step": counts["paged_decode_attention"] / steps,
            "meter_bytes": meter,
            "cache": stats, "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "peak_memory_bytes": peak,
            "launches": {k: fwd_counts[k] + counts[k] for k in counts},
            "card": smi_line}
    emit(info)
    return eng, info


def phase_times_hymba(dev, info):
    """hymba-1.5b's kernels at hymba_path's shapes, at the full depth's
    units (hymba_path runs HYMBA_LAYERS): the flash kernel over one
    32-layer forward's 32 launches (B 2, T 2,048, 25/5 heads of 64, window
    1024), and the paged kernel over one decode step's 32 launches at 8
    slots of the path's lengths, 16 tokens into their decode (window 1024,
    which these lengths do not reach)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    detail = []
    cfg = get_config("hymba-1.5b")
    L, (B, T) = cfg.num_layers, HYMBA_FWD
    window = cfg.layer_pattern[0].window
    bf = torch.bfloat16
    launches = [flash_inputs(gen, dev, B, 25, 5, T, T, 64, bf)
                for _ in range(L)]

    def fwd(fn, ls):
        return lambda: [fn(q, k, v, causal=True, window=window)
                        for q, k, v in ls]

    k_ms = graph_time_ms(fwd(ops.attention, launches), iters=10)
    eager_ms = cuda_time_ms(fwd(ops.attention, launches), iters=3)
    p_ms = cuda_time_ms(fwd(ref.flash_attention, launches), iters=1,
                        warmup=1)
    pos = torch.arange(T, device=dev)
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window))[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q0, k0, v0 = launches[0]
    detail.append({"flash_hymba_sdpa_vs_plain": float(
        (sdpa(q0, k0, v0, attn_mask=mask, enable_gqa=True).float()
         - ref.flash_attention(q0, k0, v0, causal=True, window=window)
         .float()).abs().max())})
    lib_ms = yardstick_ms(
        lambda: [sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
                 for q, k, v in launches], 10, detail, "flash_hymba_library")
    bound_ms, bound_by = flash_bound(launches, windows=[window] * L)
    flash = {"unit": f"one hymba-1.5b forward of {B} x {T} tokens: {L} "
                     "launches, 25/5 heads, D 64, causal, window 1024, bf16, "
                     "CUDA-graph replay; plain timed eagerly",
             "launches": info["forward"]["launches"]["flash_attention"],
             "ms": k_ms, "eager_ms": eager_ms, "plain_ms": p_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
             "library_note": "scaled_dot_product_attention with enable_gqa "
                             "and a boolean causal 1024-window mask on the "
                             "same tensors, CUDA-graph replay"}
    lens = [n - 1 + 16 for n in info["prompt_lens"][:HYMBA_SLOTS]]
    paged = paged_step_times(gen, dev, L, 25, 5, 64, HYMBA_MAX_LEN // 16, lens,
                             detail, "paged_hymba_library", window=window)
    paged["unit"] = (f"one decode step of hymba-1.5b: {L} launches, "
                     f"{HYMBA_SLOTS} slots, 25/5 heads, D 64, window 1024, "
                     f"lengths {lens}, CUDA-graph replay")
    paged["launches"] = info["serve_launches"]["paged_decode_attention"]
    paged["launches_per_step"] = info["paged_per_decode_step"]
    emit({"phase": "times", "path": "hymba_path", "flash_hymba": flash,
          "paged_hymba": paged, "detail": detail})
    return flash, paged


# ----------------------------------------------------------------- MoE
# The two MoE configs at every published width, cut in depth only: neither
# fits one 80 GB card at full depth (bf16 projections, float32 embedding and
# head as serve_params keeps them): phi3.5-moe holds 2.600 GB per layer
# (83.2 GB at 32 layers), qwen3-moe 4.903 GB per layer at 94 layers.
MOE_RUNS = {
    "a": dict(arch="phi3.5-moe-42b-a6.6b", layers=24, max_len=1024,
              requests=16, prompt=(64, 512), new=32, generate=(4, 128, 16),
              seed=SEED + 30),
    "b": dict(arch="qwen3-moe-235b-a22b", layers=8, max_len=512,
              requests=8, prompt=(32, 256), new=16, generate=None,
              seed=SEED + 31),
}
MOE_SLOTS, MOE_PAGE = 8, 16
# the full-width moe_apply check: the port's bf16 output against a float32
# recomputation from the same bf16 weights over the kept (token, expert)
# pairs, per row ||out - ref|| / ||ref||.  The bf16 path rounds h, g, the
# SwiGLU's steps, y, each weighted contribution and each partial sum (each
# at most 2^-9 relative): well inside 2^-6.  Rounding the expert products h
# and g to fp8 (e4m3, 3 mantissa bits, up to 2^-4 relative) lands near
# 2^-5, and the check shows that it would fail.
MOE_REL_TOL = 2.0 ** -6
MOE_TIE_GAP = 1e-5       # router near-tie: k-th and (k+1)-th probability


def moe_cfg(run):
    spec = MOE_RUNS[run]
    return dataclasses.replace(get_config(spec["arch"]),
                               num_layers=spec["layers"])


def moe_requests(vocab, spec):
    rng = np.random.default_rng(spec["seed"])
    lo, hi = spec["prompt"]
    return [Request(uid=i, prompt=rng.integers(1, vocab, int(rng.integers(
        lo, hi + 1))).astype(np.int32), max_new=spec["new"])
        for i in range(spec["requests"])]


def expert_bytes(cfg) -> int:
    """Bytes of one layer's bf16 expert stacks (w1, w3, w2)."""
    return 3 * cfg.moe.num_experts * cfg.d_model * cfg.d_ff * 2


def moe_lockstep(engs, reqs, slots):
    """Serve ``reqs`` on each engine's scheduler, stepping them in turn, and
    capture every decode step's logits (all slots) on each device.
    Returns ({device: tokens per request}, {device: [logits (n, V) f32
    on the CPU]})."""
    from repro_torch.serve import engine as engine_mod
    captured = {d: [] for d in engs}
    corrupt = engine_mod.slots_mod.corrupt_logits

    def capture(logits, bad):
        captured[str(logits.device)].append(logits.float().cpu())
        return corrupt(logits, bad)
    scheds = {d: ContinuousBatchingScheduler(e, max_slots=slots)
              for d, e in engs.items()}
    engine_mod.slots_mod.corrupt_logits = capture
    try:
        for sch in scheds.values():
            sch.begin()
            for r in reqs:
                check(sch.submit(r), "a reference request was refused")
        for _ in range(500):
            if not any(sch.has_work() for sch in scheds.values()):
                break
            for sch in scheds.values():
                sch.step()
    finally:
        engine_mod.slots_mod.corrupt_logits = corrupt
    toks = {d: [r.tokens.tolist() for r in sorted(sch.poll(),
                                                  key=lambda r: r.uid)]
            for d, sch in scheds.items()}
    return toks, captured


def phase_reference_moe(dev):
    """Reduced phi3.5-moe, reduced qwen3-moe and the top-8 override (16
    experts, top-8, GQA 16/1) on the card and on the CPU from the same
    weights: the two schedulers stepped in turn on paged pools with 4 slots
    (the MoE capacity couples the decode rows), every decode step's logits
    captured, and generate() on 3 prompts.  Tokens identical; or, at the
    first decode step whose picks differ, every earlier step's logits within
    two bf16 ulps of the largest and the card's pick short of the CPU's best
    by at most twice that (a near-tie in the logits), or a near-tie in the
    router (its smallest top-k margin on the card at most MOE_TIE_GAP):
    both gaps are reported."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    rows = []
    for seed, (name, cfg) in enumerate((
            ("phi", get_config("phi3.5-moe-42b-a6.6b").reduced()),
            ("qwen", get_config("qwen3-moe-235b-a22b").reduced()),
            ("top8", get_config("qwen3-moe-235b-a22b").reduced(
                num_heads=16, num_kv_heads=1, moe=MoEConfig(16, 8))))):
        # the two reduced configs are one model: their weights come from
        # two seeds
        params = api.init_params(
            cfg, torch.Generator().manual_seed(SEED + seed), "cpu")
        engs = {str(d): ServeEngine(cfg, params, max_len=64, page_size=8,
                                    device=d) for d in ("cpu", dev)}
        reqs = [Request(uid=i, prompt=(np.arange(1, n + 1) * 7 % 256)
                        .astype(np.int32), max_new=6)
                for i, n in enumerate((5, 9, 17, 24, 3, 12))]
        log = moe.drop_log()
        try:
            toks, logits = moe_lockstep(engs, reqs, 4)
            prompts = np.stack([(np.arange(1, 8) * (3 + i)) % 256
                                for i in range(3)]).astype(np.int32)
            gen = {d: e.generate(prompts, max_new=6)["tokens"]
                   for d, e in engs.items()}
        finally:
            moe.drop_log(False)
        card = str(dev)
        on_card = [e for e in log if e["min_gap"].device.type == dev.type]
        gaps = [float(e["min_gap"]) for e in on_card]
        rep = {"tokens_identical": (toks["cpu"] == toks[card]
                                    and np.array_equal(gen["cpu"], gen[card])),
               "decode_steps": len(logits["cpu"]),
               "dropped_assignments_card": sum(int(e["dropped"])
                                               for e in on_card),
               "router_min_gap_card": min(gaps)}
        steps = list(zip(logits["cpu"], logits[card]))
        check(len(logits["cpu"]) == len(logits[card]) or not
              rep["tokens_identical"], "the two runs took other steps")
        rep["max_abs_err"] = max((a - b).abs().max().item()
                                 for a, b in steps)
        rep["max_abs_logit"] = max(a.abs().max().item() for a, _ in steps)
        tol = 2 * bf16_ulp_of(rep["max_abs_logit"])
        rep["tolerance"] = tol
        if not rep["tokens_identical"]:
            first = next((i for i, (a, b) in enumerate(steps)
                          if not torch.equal(a.argmax(-1), b.argmax(-1))),
                         None)
            before = steps[:first] if first is not None else steps
            err = max([(a - b).abs().max().item() for a, b in before],
                      default=0.0)
            short = 0.0
            if first is not None:
                a, b = steps[first]
                pick = b.argmax(-1)
                short = (a.max(-1).values - a.gather(1, pick[:, None])[:, 0]
                         ).max().item()
            rep.update(first_divergent_step=first,
                       max_abs_err_before=err, logit_shortfall=short)
            check((err <= tol and short <= 2 * tol)
                  or rep["router_min_gap_card"] <= MOE_TIE_GAP,
                  f"reduced MoE {name}: card vs CPU {rep}")
        rows.append({"config": name, "experts": cfg.moe.num_experts,
                     "top_k": cfg.moe.top_k, **rep})
    emit({"phase": "reference_moe", "runs": rows,
          "tolerance": "tokens identical; or where they first differ, the "
                       "logits before within 2 bf16 ulps of the largest "
                       "|logit| and the card's pick short of the CPU's best "
                       f"by at most twice that, or a router near-tie (top-k "
                       f"margin <= {MOE_TIE_GAP})"})


def moe_reference_out(p, xt, gate, ids, C, E):
    """float32 recomputation of moe_apply's output from the same bf16
    weights: for each expert its kept tokens (the port's own routing and
    capacity), SwiGLU in float32, weighted by the gates and summed per
    token; also the same with the expert products h and g rounded to fp8
    (e4m3).  Returns (ref, ref_fp8), (n, d) float32."""
    from repro_torch.models import moe
    order, tok, keep, dest = moe.dispatch(ids, C, E)
    sorted_ids = ids.reshape(-1)[order]
    w_sorted = gate.reshape(-1)[order]
    n, d = xt.shape
    out = torch.zeros((n, d), dtype=torch.float32, device=xt.device)
    out8 = torch.zeros_like(out)
    f8 = torch.float8_e4m3fn
    for e in range(E):
        sel = torch.nonzero((sorted_ids == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        t = tok[sel]
        xe = xt[t].float()
        h = xe @ p["w1"][e].float()
        g = xe @ p["w3"][e].float()
        w = w_sorted[sel][:, None]
        out.index_add_(0, t, (torch.nn.functional.silu(h) * g)
                       @ p["w2"][e].float() * w)
        h8, g8 = h.to(f8).float(), g.to(f8).float()
        out8.index_add_(0, t, (torch.nn.functional.silu(h8) * g8)
                        @ p["w2"][e].float() * w)
    return out, out8


def phase_moe_check(eng, dev, run):
    """moe_apply at full width on layer 0 of the path's weights, for a
    decode batch of 8 rows and a 512-token prefill: the output against a
    float32 recomputation over the kept pairs (MOE_REL_TOL), a second call
    bit-identical, the router's top-k sets against a float32 softmax's
    (a differing set only at a near-tie, gap reported); and the quantized
    branch (W4A8 codes of layer 0's w1 and w2, one kernel launch per
    expert) bit-identical to its plain version."""
    from repro_torch.core import quant
    from repro_torch.models import moe
    cfg = eng.cfg
    mc = cfg.moe
    E, k, d = mc.num_experts, mc.top_k, cfg.d_model
    p = {name: w[0, 0] for name, w in eng.params["blocks"]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    rows = []
    qw = {name: api.quantize_model({name: p[name]}, cfg)[name].with_packed()
          for name in ("w1", "w2")}
    for n in (8, 512):
        x = torch.randn((1, n, d), generator=gen, device=dev).to(torch.bfloat16)
        out, _ = moe.moe_apply(p, x, mc)
        again, _ = moe.moe_apply(p, x, mc)
        check(torch.equal(out, again), f"moe_apply {run} n={n}: a second "
              "call gave other bits")
        xt = x[0]
        C = moe.capacity(n, mc)
        probs, gate, ids = moe.route(p, xt, mc)
        _, _, keep, _ = moe.dispatch(ids, C, E)
        pr32 = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        top = torch.sort(pr32, dim=-1, descending=True).values
        ids32 = torch.topk(pr32, k, dim=-1).indices
        differ = (torch.sort(ids32, dim=1).values
                  != torch.sort(ids, dim=1).values).any(dim=1)
        gaps = (top[:, k - 1] - top[:, k])[differ]
        check(bool((gaps <= MOE_TIE_GAP).all()), f"moe {run} n={n}: router "
              f"sets differ from float32 away from a near-tie {gaps}")
        ref_out, ref8 = moe_reference_out(p, xt, gate, ids, C, E)
        norm = ref_out.norm(dim=1).clamp_min(1e-30)
        rel = ((out[0].float() - ref_out).norm(dim=1) / norm).max().item()
        rel8 = ((ref8 - ref_out).norm(dim=1) / norm).max().item()
        check(rel <= MOE_REL_TOL, f"moe {run} n={n}: relative error {rel} "
              f"> {MOE_REL_TOL}")
        check(rel8 > MOE_REL_TOL, f"moe {run} n={n}: the tolerance would "
              f"pass fp8 expert products ({rel8})")
        # the quantized branch on the dispatched rows of this call
        order, tok, _, dest = moe.dispatch(ids, C, E)
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
        buf[dest] = xt[tok]
        eb = buf[:-1].reshape(E, C, d)
        hb = moe._expert_matmul(eb, p["w1"])
        q_exact = True
        for name, a in (("w1", eb), ("w2", hb)):
            got = moe._expert_matmul(a, qw[name])
            qx, xs = quant.quantize_activations_int8(
                a.reshape(E * C, -1), reciprocal=True)
            qx, xs = qx.reshape(E, C, -1), xs.reshape(E, C, 1)
            plain = torch.stack([ref.w4a8_matmul(
                qx[e], xs[e], qw[name].codes[e], qw[name].scales[e],
                torch.bfloat16) for e in range(E)])
            q_exact &= torch.equal(got, plain)
        check(q_exact, f"moe {run} n={n}: the W4A8 expert products differ "
              "from their plain version")
        rows.append({"rows": n, "capacity": C,
                     "dropped": int((~keep).sum()), "assignments": n * k,
                     "max_rel_err": rel, "fp8_products_rel_err": rel8,
                     "router_sets_differing": int(differ.sum()),
                     "router_near_tie_gaps": gaps.tolist(),
                     "second_call_identical": True,
                     "w4a8_experts_bit_identical": True})
    del qw
    emit({"phase": "moe_check", "run": run, "config": cfg.name,
          "experts": E, "top_k": k, "cases": rows,
          "tolerance": f"per row ||out - ref|| / ||ref|| <= {MOE_REL_TOL} "
                       "(bf16 roundings of the path; fp8 expert products "
                       "exceed it); router sets as float32's except where "
                       f"the k-th and (k+1)-th probabilities are within "
                       f"{MOE_TIE_GAP}; W4A8 bit-identical"})


def moe_drops(log, L, slots, reqs):
    """The drop log of a scheduler run, per decode step (the L layers'
    calls of one step over every slot) and per prefill.  The prefills come
    in the requests' order (no chunking, no preemption): each one's first
    ``len(prompt) - 1`` rows are the prompt, the rest its bucket's zero
    padding, whose rows come last and so claim capacity last."""
    dec = [e for e in log if e["rows"] == slots]
    pre = [e for e in log if e["rows"] != slots]
    check(len(dec) % L == 0 and len(pre) == L * len(reqs), "MoE calls not "
          "the layer count per decode step and per prefill")
    per_step = [sum(int(e["dropped"]) for e in dec[i:i + L])
                for i in range(0, len(dec), L)]
    per_pre = [sum(int(e["dropped"]) for e in pre[i:i + L])
               for i in range(0, len(pre), L)]
    real = [len(r.prompt) - 1 for r in reqs]
    per_pre_real = [sum(int(e["dropped_rows"][:t].sum())
                        for e in pre[L * i:L * (i + 1)])
                    for i, t in enumerate(real)]
    k = pre[0]["assignments"] // pre[0]["rows"]
    return {"decode_steps": len(per_step),
            "dropped_per_decode_step_mean": float(np.mean(per_step)),
            "dropped_per_decode_step_max": max(per_step),
            "decode_assignments_per_step": sum(e["assignments"]
                                               for e in dec[:L]),
            "decode_drop_share": sum(per_step) / max(
                1, sum(e["assignments"] for e in dec)),
            "prefills": len(per_pre),
            "dropped_per_prefill": per_pre,
            "prefill_drop_share": sum(per_pre) / max(
                1, sum(e["assignments"] for e in pre)),
            "dropped_prompt_rows_per_prefill": per_pre_real,
            "prefill_drop_share_prompt_rows": sum(per_pre_real) / max(
                1, L * k * sum(real))}


def phase_moe_path(dev, smi_line, run):
    """One MoE config at full width, cut in depth (MOE_RUNS), on the float
    ServeEngine: the scheduler over a page pool with 8 slots (a warm-up,
    then the timed run with the counts set to 0 just before and read just
    after: every request DONE, one flash launch per layer per prefill and
    one paged launch per layer per decode step, meter exact), a second run
    token-identical with the drop log open, and for run (a) generate()
    on 4 x 128 tokens twice."""
    from repro_torch.models import moe
    spec = MOE_RUNS[run]
    cfg = moe_cfg(run)
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             device=dev, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, max_len=spec["max_len"],
                      page_size=MOE_PAGE, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [eng.params["embed"], eng.params["lm_head"]]
                       + [w for part in eng.params["blocks"].values()
                          for w in (part.values() if isinstance(part, dict)
                                    else [part])])
    sched = ContinuousBatchingScheduler(eng, max_slots=MOE_SLOTS)
    clock = PhaseClock(eng)
    sched.warmup(prompt_len=64, max_new=4)
    reqs = moe_requests(cfg.vocab_size, spec)
    from repro_torch.serve.slots import bucket
    check(all(bucket(len(r.prompt) - 1) <= spec["max_len"] for r in reqs),
          "a prompt's bucket does not fit max_len: no block prefill")
    clock.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s, admit_s = clock.decode_s, clock.admit_s
    res = out["results"]
    check(len(res) == len(reqs) and all(r.state == "DONE" for r in res),
          f"moe {run}: not every request DONE: {out['by_state']}")
    check(all(r.gen_len == spec["new"] for r in res), "a request stopped short")
    check(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "token out of range")
    check(out["quarantines"] == 0 and out["failed"] == 0,
          "the finite-logits sentinel flagged a step")
    steps, prefill = out["steps"], out["prefill_tokens"]
    check(prefill == sum(len(r.prompt) - 1 for r in reqs), "prefill tokens")
    want = {"w4a8_matmul": 0, "flash_attention": L * len(reqs),
            "paged_decode_attention": L * steps, "rwkv6_scan": 0}
    check(counts == want, f"moe {run} launch counts {counts} != {want}")
    tokens = prefill + out["decoded_tokens"]
    meter = eng.measured_bytes()["total"]
    check(meter == traffic_model_for(cfg).bytes_per_token() * tokens,
          f"meter {meter} != eq. 7-10 x {tokens} tokens")
    stats = eng.cache_stats(sched.cache)
    first = [r.tokens.tolist() for r in res]
    log = moe.drop_log()
    try:
        again = sched.run(reqs)
    finally:
        moe.drop_log(False)
    check([r.tokens.tolist() for r in again["results"]] == first,
          "a second identical run gave other tokens")
    drops = moe_drops(log, L, MOE_SLOTS, reqs)
    del log
    launches = dict(counts)
    gen_info = None
    if spec["generate"]:
        gb, gt, gn = spec["generate"]
        prompts = np.random.default_rng(spec["seed"] + 1).integers(
            1, cfg.vocab_size, (gb, gt)).astype(np.int32)
        ops.reset_launch_counts()
        g1 = eng.generate(prompts, max_new=gn)
        gen_counts = ops.launch_counts()
        g2 = eng.generate(prompts, max_new=gn)
        check(gen_counts == {"w4a8_matmul": 0, "flash_attention": L,
                             "paged_decode_attention": 0, "rwkv6_scan": 0},
              f"generate() launch counts {gen_counts}")
        check(np.array_equal(g1["tokens"], g2["tokens"])
              and g1["tokens"].shape == (gb, gn)
              and bool(((g1["tokens"] >= 0)
                        & (g1["tokens"] < cfg.vocab_size)).all()),
              "generate() tokens out of range or not repeatable")
        launches = {key: launches[key] + gen_counts[key] for key in launches}
        gen_info = {"batch": gb, "prompt_len": gt, "max_new": gn,
                    "launches": gen_counts, "repeatable": True,
                    "prefill_s": g1["prefill_s"], "decode_s": g1["decode_s"],
                    "decode_tokens_per_s": g1["tokens_per_s"]}
    info = {"phase": "moe_path", "run": run, "config": cfg.name,
            "layers": L, "layers_published": get_config(spec["arch"])
            .num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "experts": cfg.moe.num_experts,
            "top_k": cfg.moe.top_k, "dtype": cfg.dtype,
            "max_slots": MOE_SLOTS, "page_size": MOE_PAGE,
            "max_len": spec["max_len"], "num_pages": eng._pager.pool.num_pages,
            "requests": len(reqs), "all_done": True, "setup_s": setup_s,
            "weight_bytes": weight_bytes,
            "expert_bytes_per_layer": expert_bytes(cfg),
            "prefill_tokens": prefill,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "decode_steps": steps, "decoded_tokens": out["decoded_tokens"],
            "serve_launches": counts, "launches_expected": want,
            "flash_per_prefill": counts["flash_attention"] / len(reqs),
            "paged_per_decode_step": counts["paged_decode_attention"] / steps,
            "meter_bytes": meter, "second_run_identical": True,
            "drops": drops, "cache": stats,
            "wall_s": out["wall_s"], "decode_s": decode_s,
            "admit_s": admit_s,
            "decode_steps_per_s": steps / decode_s,
            "decode_tokens_per_s": out["decoded_tokens"] / decode_s,
            "prefill_tokens_per_s": prefill / admit_s,
            "tokens_per_s_wall": out["tokens_per_s"],
            "generate": gen_info, "launches": launches,
            "peak_memory_bytes": peak, "setup_peak_memory_bytes": setup_peak,
            "card": smi_line}
    emit(info)
    return eng, info


def phase_moe_ffn_time(eng, dev, run):
    """The expert FFN of one decode step at 8 slots: every layer's three
    grouped products over its (E, C, d) buffer (C = capacity(8)) and the
    SwiGLU between them, replayed from a CUDA graph, against the bound of
    reading every expert's weights once; and moe_apply over the layers
    eagerly (routing, dispatch and combine included, host gaps too)."""
    from repro_torch.models import moe
    cfg = eng.cfg
    mc, L, d, f = cfg.moe, cfg.num_layers, cfg.d_model, cfg.d_ff
    E, C = mc.num_experts, moe.capacity(MOE_SLOTS, cfg.moe)
    ws = eng.params["blocks"]["moe"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    eb = torch.randn((E, C, d), generator=gen, device=dev).to(torch.bfloat16)

    def ffn():
        for g in range(L):
            h = moe._expert_matmul(eb, ws["w1"][g, 0])
            u = moe._expert_matmul(eb, ws["w3"][g, 0])
            moe._expert_matmul(moe._silu(h) * u, ws["w2"][g, 0])

    ms = graph_time_ms(ffn, iters=10)
    x = torch.randn((MOE_SLOTS, 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    layers = [{k: w[g, 0] for k, w in ws.items()} for g in range(L)]
    apply_ms = cuda_time_ms(lambda: [moe.moe_apply(p, x, mc)
                                     for p in layers], iters=3)
    nbytes = L * (expert_bytes(cfg) + 2 * E * C * (2 * d + 2 * f))
    flops = L * 2 * E * C * 3 * d * f
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    row = {"unit": f"the expert FFN of one {cfg.name} decode step at "
                   f"{MOE_SLOTS} slots: {L} layers x (3 grouped bf16 "
                   f"products over ({E}, {C}, {d}) rows and the SwiGLU), "
                   "CUDA-graph replay",
           "ms": ms, "bound_ms": bound,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / BF16_FLOPS_PER_S else "operations"),
           "expert_bytes_per_step": L * expert_bytes(cfg),
           "moe_apply_eager_ms_per_step": apply_ms,
           "note": "torch.bmm (cuBLAS), the reference's einsum outside any "
                   "Pallas kernel: not a kernel of the port"}
    emit({"phase": "times", "path": f"moe_path ({run})", "expert_ffn": row})
    return row


def phase_times_moe(dev, info_a, info_b):
    """The flash and paged kernels at the two MoE shapes: phi3.5-moe's
    (32/8 heads of 128: a 512-token prefill's 24 launches, a decode step's
    24 launches at run (a)'s lengths) and qwen3-moe's (64/4 heads of 64,
    group 16: a 256-token prefill's 8 launches, a decode step's 8 launches
    at run (b)'s lengths), each flash shape first held against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    detail, rows = [], {}
    bf = torch.bfloat16
    for run, info, T in (("a", info_a, 512), ("b", info_b, 256)):
        L, (Hq, Hkv), D = info["layers"], info["heads"], info["head_dim"]
        launches = [flash_inputs(gen, dev, 1, Hq, Hkv, T, T, D, bf)
                    for _ in range(L)]
        q0, k0, v0 = launches[0]
        got = ops.attention(q0, k0, v0, causal=True).float()
        plain = ref.flash_attention(q0, k0, v0, causal=True).float()
        err = (got - plain).abs()
        check(bool((err <= bf16_ulp(plain) + 1e-5).all()),
              f"flash at the {info['config']} shape outside tolerance "
              f"({err.max().item()})")

        def prefill(fn, ls):
            return lambda: [fn(q, k, v, causal=True) for q, k, v in ls]

        k_ms = graph_time_ms(prefill(ops.attention, launches), iters=10)
        eager_ms = cuda_time_ms(prefill(ops.attention, launches), iters=3)
        p_ms = graph_time_ms(prefill(ref.flash_attention, launches), iters=3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = yardstick_ms(
            lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True)
                     for q, k, v in launches], 10, detail,
            f"flash_moe_{run}_library")
        bound_ms, bound_by = flash_bound(launches)
        flash = {"unit": f"one {T}-token prefill of {info['config']}: {L} "
                         f"launches, B 1, {Hq}/{Hkv} heads, D {D}, causal, "
                         "bf16, CUDA-graph replay",
                 "launches": info["launches"]["flash_attention"],
                 "ms": k_ms, "eager_ms": eager_ms, "plain_ms": p_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": lib_ms, "max_abs_err": err.max().item(),
                 "library_note": "scaled_dot_product_attention(is_causal="
                                 "True, enable_gqa=True) on the same tensors"}
        lens = [n - 1 + 16 for n in info["prompt_lens"][:MOE_SLOTS]]
        paged = paged_step_times(gen, dev, L, Hq, Hkv, D,
                                 info["max_len"] // MOE_PAGE, lens, detail,
                                 f"paged_moe_{run}_library")
        paged["unit"] = (f"one decode step of {info['config']}: {L} "
                         f"launches, {MOE_SLOTS} slots, {Hq}/{Hkv} heads, "
                         f"D {D}, lengths {lens}, CUDA-graph replay")
        paged["launches"] = info["launches"]["paged_decode_attention"]
        paged["launches_per_step"] = info["paged_per_decode_step"]
        rows[run] = (flash, paged)
    emit({"phase": "times", "path": "moe_path",
          "flash_phi_moe": rows["a"][0], "paged_phi_moe": rows["a"][1],
          "flash_qwen_moe": rows["b"][0], "paged_qwen_moe": rows["b"][1],
          "detail": detail})
    return rows


def phase_lm_forward(eng, dev, path, T=128):
    """The lm family's whole-sequence ``api.forward`` on a path's engine at
    full width: one row of T seeded tokens, the counts set to 0 just before
    and read just after (one flash launch per layer, nothing else), finite
    logits, and the last position's logits against the block prefill's on
    the same tokens (``pick_report``'s near-tie rule, the gap at most
    FWD_GAP_SHARE of the largest |logit|: the forward rounds its head
    product, the prefill does not).  Returns the counts."""
    cfg = eng.cfg
    toks = torch.as_tensor(np.random.default_rng(SEED + 43).integers(
        1, cfg.vocab_size, (1, T)).astype(np.int32), device=dev)
    ops.reset_launch_counts()
    fwd, aux = api.forward(eng.params, toks, cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {"w4a8_matmul": 0, "flash_attention": cfg.num_layers,
            "paged_decode_attention": 0, "rwkv6_scan": 0}
    check(counts == want, f"{path} forward launch counts {counts} != {want}")
    check(fwd.shape == (1, T, cfg.vocab_size)
          and bool(torch.isfinite(fwd).all()), f"{path} forward logits")
    last = fwd[:, -1].float().cpu()
    del fwd
    pre, _ = api.prefill(eng.params, api.init_cache(cfg, 1, T, device=dev),
                         toks, cfg)
    rep = pick_report(pre.float().cpu(), last, last.argmax(-1))
    check((rep["argmax_agree"] == rep["n"]
           or rep["shortfall"] <= 2 * rep["max_abs_err"])
          and rep["max_abs_err"] <= FWD_GAP_SHARE * rep["max_abs_logit"],
          f"{path} forward against the block prefill: {rep}")
    emit({"phase": "lm_forward", "path": path, "config": cfg.name,
          "layers": cfg.num_layers, "tokens": [1, T], "launches": counts,
          "aux": float(aux), "against_prefill": rep})
    return counts


def run_moe(dev, smi):
    """The MoE phases: the reduced configs card against CPU, then runs (a)
    and (b), each with its full-width moe_apply check, its profile and its
    expert FFN time, then the kernels' times at both shapes."""
    phase_reference_moe(dev)
    infos, profs, ffn, fwd_counts = {}, {}, {}, {}
    for run in ("a", "b"):
        eng, infos[run] = phase_moe_path(dev, smi, run)
        phase_moe_check(eng, dev, run)
        profs[run] = phase_profile(eng, dev, f"moe_path ({run})",
                                   slots=MOE_SLOTS)
        fwd_counts[run] = phase_lm_forward(eng, dev, f"moe_path ({run})")
        ffn[run] = phase_moe_ffn_time(eng, dev, run)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rows = phase_times_moe(dev, infos["a"], infos["b"])
    emit({"moe_path_summary": {
        run: {**{key: infos[run][key] for key in (
            "config", "layers", "decode_steps_per_s", "decode_tokens_per_s",
            "prefill_tokens_per_s", "tokens_per_s_wall",
            "setup_peak_memory_bytes", "peak_memory_bytes")},
            "drops": {key: infos[run]["drops"][key] for key in (
                "dropped_per_decode_step_mean", "decode_drop_share",
                "prefill_drop_share", "prefill_drop_share_prompt_rows")},
            "profile": {key: profs[run][key] for key in (
                "wall_ms_per_step", "device_ms_per_step",
                "device_busy_share", "host_ops_per_step")},
            "expert_ffn_ms_per_decode_step": ffn[run]["ms"],
            "expert_ffn_bound_ms": ffn[run]["bound_ms"]}
        for run in ("a", "b")}, "card": smi})
    launches = {k: infos["a"]["launches"][k] + infos["b"]["launches"][k]
                for k in infos["a"]["launches"]}
    return launches, rows, {k: fwd_counts["a"][k] + fwd_counts["b"][k]
                            for k in fwd_counts["a"]}


# ------------------------------------------------ cross-attention families
# llama-3.2-vision-11b (the lm family's cross-attention member) and
# seamless-m4t-medium (the encoder-decoder family), both at every published
# width and full depth: served through generate() only, as the JAX package
# serves them.  The reference's cross gates start at zero, and tanh(0) = 0
# makes a fresh VLM's cross blocks add nothing: every gate is set to a
# seeded value of magnitude 0.25-1 here, and the reduced configs take
# XATTN_GATES.
XATTN_GATES = (0.7, -0.9)
VISION = dict(arch="llama-3.2-vision-11b", batch=4, prompt=128, new=32,
              step=(2, 16, 8), seed=SEED + 40)
ENCDEC = dict(arch="seamless-m4t-medium", batch=4, prompt=64, new=32,
              step=(2, 16, 8), fwd=(2, 256), seed=SEED + 41)
FWD_GAP_SHARE = 0.1   # forward against decode logits: at most this share
                      # of the largest |logit| apart (a dropped or broken
                      # block moves them by the logits' own size)


def xattn_gates(n, gen):
    """``n`` seeded cross gates, magnitude uniform in [0.25, 1), either
    sign (float32, on the generator's device)."""
    mag = 0.25 + 0.75 * torch.rand(n, generator=gen, device=gen.device)
    sign = torch.rand(n, generator=gen, device=gen.device) < 0.5
    return torch.where(sign, -mag, mag)


def phase_reference_xattn(dev):
    """Reduced llama-3.2-vision-11b (cross gates XATTN_GATES) and reduced
    seamless-m4t-medium on the card (kernels) and on the CPU (plain
    versions) from the same weights and frontends: generate() fused and
    stepwise, and with a stop token: identical tokens and gen_len."""
    rows = []
    for i, arch in enumerate((VISION["arch"], ENCDEC["arch"])):
        cfg = get_config(arch).reduced()
        params = api.init_params(cfg, torch.Generator().manual_seed(SEED + i),
                                 "cpu")
        if cfg.cross_attn_every:
            params["cross"]["gate"] = torch.tensor(XATTN_GATES)
        rng = np.random.default_rng(SEED + 40 + i)
        prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
        fe = rng.standard_normal(
            (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        engs = {str(d): ServeEngine(cfg, params, max_len=32, device=d)
                for d in ("cpu", dev)}
        eos = int(engs["cpu"].generate(prompts, max_new=8, frontend=fe)
                  ["tokens"][0, 2])
        got = {}
        for d, eng in engs.items():
            for fused in (True, False):
                for stop in (None, eos):
                    out = eng.generate(prompts, max_new=8, frontend=fe,
                                       fused=fused, eos_id=stop)
                    got[d, fused, stop] = (out["tokens"].tolist(),
                                           out["gen_len"].tolist())
        card = str(dev)
        same = all(got["cpu", f, e] == got[card, f, e]
                   for f in (True, False) for e in (None, eos))
        check(same, f"reduced {arch}: card tokens differ from the CPU's")
        check(all(got["cpu", True, e] == got["cpu", False, e]
                  for e in (None, eos)), f"reduced {arch}: fused and "
              "stepwise generate() differ")
        rows.append({"config": arch, "tokens_identical": True,
                     "eos_id": eos, "gen_len_eos": got[card, True, eos][1],
                     "gates": list(XATTN_GATES) if cfg.cross_attn_every
                     else None})
    emit({"phase": "reference_xattn", "runs": rows,
          "tolerance": "tokens and gen_len identical, card and CPU, fused "
                       "and stepwise, with and without eos_id"})


def _capture_decode_logits(fn):
    """Run ``fn()`` with every ``api.decode_step``'s logits kept on the
    device (no sync); returns (fn's result, [logits (B, V)])."""
    from repro_torch.serve import engine as engine_mod
    kept, step = [], engine_mod.api.decode_step

    def spy(*a, **kw):
        logits, cache = step(*a, **kw)
        kept.append(logits.clone())
        return logits, cache
    engine_mod.api.decode_step = spy
    try:
        out = fn()
    finally:
        engine_mod.api.decode_step = step
    return out, kept


def first_divergence_report(fused, step, fused_logits, step_logits):
    """Fused against stepwise generate() on the same inputs: identical
    tokens, or at the first decode step where a row's pick differs, the
    stepwise pick a near-tie in the fused run's logits there (``pick_report``'s
    rule: short of their largest by at most twice the two runs' logit gap,
    that gap at most FWD_GAP_SHARE of the largest |logit|).  The two runs
    prefill differently (the block prefill's GEMMs over the whole prompt,
    one decode step per prompt token), so on the card their bf16 products
    round apart; the CPU's reduced runs are held identical."""
    if np.array_equal(fused, step):
        return {"identical": True, "near_tie": False}
    i = int(np.argwhere((fused != step).any(axis=0))[0, 0])
    rep = pick_report(fused_logits[i].float().cpu(),
                      step_logits[i].float().cpu(), step[:, i])
    rep.update(identical=False, first_differing_step=i,
               near_tie=(rep["shortfall"] <= 2 * rep["max_abs_err"]
                         and rep["max_abs_err"]
                         <= FWD_GAP_SHARE * rep["max_abs_logit"]))
    return rep


def forward_pick_report(fwd, dec, picks, T0):
    """The forward's logits at the positions that chose ``picks`` (B, n)
    after T0-token prompts, against the decode steps' logits there
    (``dec``: n tensors (B, V)): ``pick_report``'s rule, with the forward in
    the reference's place."""
    n = picks.shape[1]
    f = fwd[:, T0 - 1:T0 - 1 + n].reshape(-1, fwd.shape[-1]).float().cpu()
    d = torch.stack(dec, dim=1).reshape(-1, fwd.shape[-1]).float().cpu()
    rep = pick_report(f, d, picks.reshape(-1))
    rep["near_tie_ok"] = (rep["argmax_agree"] == rep["n"]
                          or rep["shortfall"] <= 2 * rep["max_abs_err"])
    return rep


def profile_generate(eng, dev, path, prompts, fe, n=5):
    """torch.profiler over ``n`` lockstep decode steps of ``generate()``'s
    loop (the dense cache with the frontend's cross K/V, after the prompt's
    prefill and two warm steps): device time by kernel, busy share, host
    ops per step."""
    from torch.profiler import ProfilerActivity, profile
    cfg = eng.cfg
    toks = torch.as_tensor(prompts, device=dev)
    B, T0 = prompts.shape
    cache = api.init_cache(cfg, B, eng.max_len, frontend=fe,
                           params=eng.params, device=dev, tp=eng.tp)
    _, cache = api.prefill_bucketed(eng.params, cache, toks[:, :-1], T0 - 1,
                                    cfg)
    tok = toks[:, -1]
    for _ in range(2):
        logits, cache = api.decode_step(eng.params, cache, tok, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            logits, cache = api.decode_step(eng.params, cache, tok, cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    info = {"phase": "profile", "path": path, "config": cfg.name,
            "batch": B, **profile_summary(prof, wall, n, path),
            "flash_per_step": ops.launch_counts()["flash_attention"] / n}
    emit(info)
    return info


def xattn_setup(dev, spec, build_params):
    """Draw a config's bf16 weights on the card and build its ServeEngine:
    (cfg, engine, setup seconds, setup peak bytes, weight bytes)."""
    cfg = get_config(spec["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_params(cfg)
    eng = ServeEngine(cfg, params, max_len=spec["max_len"], device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(eng.params))
    return (cfg, eng, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(), weight_bytes)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def xattn_serve(eng, dev, spec, prompts, fe, flash_per_call, name):
    """The timed generate() of a cross-attention path and its checks:
    counts set to 0 just before and read just after (the pin
    ``flash_per_call``), meter exact, a second call token-identical (its
    decode logits kept for the forward check), and stepwise generate() on
    ``spec["step"]`` (batch, prompt, new) token-identical to a fused call
    on the same inputs.  Returns (info, the timed call's tokens, the second
    call's decode logits)."""
    cfg = eng.cfg
    B, T0 = prompts.shape
    new = spec["new"]
    eng.generate(prompts[:1, :16], max_new=2, frontend=fe[:1])   # warm-up
    eng.meter.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=new, frontend=fe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"w4a8_matmul": 0, "flash_attention": flash_per_call,
            "paged_decode_attention": 0, "rwkv6_scan": 0}
    check(counts == want, f"{name} generate() launch counts {counts} != "
          f"{want}")
    toks = out["tokens"]
    check(toks.shape == (B, new) and bool(((toks >= 0)
                                           & (toks < cfg.vocab_size)).all())
          and (out["gen_len"] == new).all(), f"{name}: tokens out of range")
    meter = eng.measured_bytes()["total"]
    ntok = B * (T0 - 1) + int(out["gen_len"].sum())
    check(meter == traffic_model_for(cfg).bytes_per_token() * ntok,
          f"{name}: meter {meter} != eq. 7-10 x {ntok} tokens")
    again, dec = _capture_decode_logits(
        lambda: eng.generate(prompts, max_new=new, frontend=fe))
    check(np.array_equal(again["tokens"], toks),
          f"{name}: a second identical generate() gave other tokens")
    sb, st, sn = spec["step"]
    ops.reset_launch_counts()
    step, step_logits = _capture_decode_logits(
        lambda: eng.generate(prompts[:sb, :st], max_new=sn, frontend=fe[:sb],
                             fused=False))
    step_counts = ops.launch_counts()
    fused, fused_logits = _capture_decode_logits(
        lambda: eng.generate(prompts[:sb, :st], max_new=sn,
                             frontend=fe[:sb]))
    agree = first_divergence_report(fused["tokens"], step["tokens"],
                                    fused_logits[-sn:], step_logits[-sn:])
    check(agree["identical"] or agree["near_tie"],
          f"{name}: stepwise and fused generate() differ: {agree}")
    info = {"batch": B, "prompt_len": T0, "max_new": new,
            "launches": counts, "flash_per_call": flash_per_call,
            "meter_bytes": meter, "second_call_identical": True,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "wall_s": wall,
            "decode_steps_per_s": new / out["decode_s"],
            "decode_tokens_per_s": out["tokens_per_s"],
            "prefill_tokens_per_s": B * (T0 - 1) / out["prefill_s"],
            "peak_memory_bytes": peak,
            "stepwise": {"batch": sb, "prompt_len": st, "max_new": sn,
                         "launches": step_counts,
                         "against_fused": agree,
                         "decode_tokens_per_s": step["tokens_per_s"]}}
    return info, toks, dec


# the live-cross check's second frontend is a fresh draw shifted by 1:
# attention over 1,600 i.i.d. keys averages two unshifted draws to nearly
# the same output, while a shift moves every value row alike


def phase_vision_path(dev, smi_line):
    """llama-3.2-vision-11b at full width and depth (40 self layers in 8
    groups of 5, a gated cross block after each; 32/8 heads of 128, d_ff
    14,336, vocab 128,256, 1,600 frontend tokens of 4,096), bf16
    projections drawn per slice from a seeded generator on the card, every
    cross gate set to a seeded non-zero value: generate() on 4 prompts of
    128 tokens with 4 frontends, 32 new (48 flash launches per prefill: 40
    causal and 8 cross; 8 per decode step: the cross blocks at one query
    row), a second call token-identical, stepwise on 2 x 16 prompts with
    8 new (8 launches per step) token-identical to fused; forward on the
    prompts and the generated tokens (48 launches), whose argmax at each
    generated position is the decoded token or a near-tie; a second
    frontend changes the logits (the cross path is live)."""
    spec = dict(VISION, max_len=VISION["prompt"] + VISION["new"])
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def build(cfg):
        params = api.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
        params["cross"]["gate"] = xattn_gates(
            cfg.num_layers // cfg.cross_attn_every, gen)
        return params
    cfg, eng, setup_s, setup_peak, wbytes = xattn_setup(dev, spec, build)
    L, G = cfg.num_layers, cfg.num_layers // cfg.cross_attn_every
    B, T0, new = spec["batch"], spec["prompt"], spec["new"]
    rng = np.random.default_rng(spec["seed"])
    prompts = rng.integers(1, cfg.vocab_size, (B, T0)).astype(np.int32)
    fgen = torch.Generator(device=dev).manual_seed(spec["seed"])
    fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model), generator=fgen,
                     device=dev)
    info, toks, dec = xattn_serve(eng, dev, spec, prompts, fe,
                                  L + G + G * new, "vision_path")
    sb, st, sn = spec["step"]
    check(info["stepwise"]["launches"]["flash_attention"]
          == G * (st - 1 + sn), f"vision_path stepwise launches "
          f"{info['stepwise']['launches']}")
    seq = torch.from_numpy(np.concatenate([prompts, toks], 1)).to(dev)
    ops.reset_launch_counts()
    fwd, _ = api.forward(eng.params, seq, cfg, frontend=fe)
    torch.cuda.synchronize()
    fwd_counts = ops.launch_counts()
    check(fwd_counts["flash_attention"] == L + G,
          f"vision_path forward launches {fwd_counts}")
    check(bool(torch.isfinite(fwd).all()) and fwd.shape == (
        B, T0 + new, cfg.vocab_size), "vision_path forward logits")
    rep = forward_pick_report(fwd, dec, toks, T0)
    check(rep["near_tie_ok"] and rep["max_abs_err"]
          <= FWD_GAP_SHARE * rep["max_abs_logit"],
          f"vision_path forward against decode: {rep}")
    other = torch.randn(fe.shape, generator=fgen, device=dev) + 1.0
    fwd2, _ = api.forward(eng.params, seq, cfg, frontend=other)
    live = (fwd2 - fwd).abs().max().item()
    del fwd, fwd2
    check(live > rep["max_abs_err"], f"vision_path: another frontend moves "
          f"the logits by {live} only")
    launches = {k: info["launches"][k] + info["stepwise"]["launches"][k]
                + fwd_counts[k] for k in fwd_counts}
    prof = profile_generate(eng, dev, "vision_path", prompts, fe)
    info.update({"phase": "vision_path", "config": cfg.name, "layers": L,
                 "cross_blocks": G, "d_model": cfg.d_model,
                 "heads": [cfg.num_heads, cfg.num_kv_heads],
                 "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab_size,
                 "frontend_tokens": cfg.frontend_tokens,
                 "gates": eng.params["cross"]["gate"].tolist(),
                 "setup_s": setup_s, "setup_peak_memory_bytes": setup_peak,
                 "weight_bytes": wbytes,
                 "flash_per_prefill": L + G, "flash_per_decode_step": G,
                 "forward": {"tokens": [B, T0 + new],
                             "launches": fwd_counts, "picks": rep,
                             "other_frontend_max_abs_change": live},
                 "launches_total": launches,
                 "profile": {k: prof[k] for k in (
                     "wall_ms_per_step", "device_ms_per_step",
                     "device_busy_share", "host_ops_per_step")},
                 "card": smi_line})
    emit(info)
    return eng, info


def phase_encdec_path(dev, smi_line):
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers, d_model 1,024, 16/16 heads of 64, d_ff 4,096, vocab
    256,206, 960 frontend frames), bf16 projections drawn per slice from a
    seeded generator on the card: generate() on 4 prompts of 64 tokens
    with 960-frame frontends, 32 new (12 flash launches per call: the
    encoder, once per batch; its decode steps attend through the plain
    decode_attention, as in the reference), a second call token-identical,
    stepwise on 2 x 16 prompts with 8 new token-identical to fused; then
    generate() on 2 prompts of 224 tokens with 32 new and forward on those
    2 x 256 tokens (36 launches: 12 encoder, 12 causal self, 12 cross),
    whose argmax at each generated position is the decoded token or a
    near-tie; a second frontend changes the logits."""
    fb, ft = ENCDEC["fwd"]
    spec = dict(ENCDEC, max_len=ft)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, eng, setup_s, setup_peak, wbytes = xattn_setup(
        dev, spec, lambda cfg: api.init_params(cfg, gen, device=dev,
                                               dtype=torch.bfloat16))
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    B, T0, new = spec["batch"], spec["prompt"], spec["new"]
    rng = np.random.default_rng(spec["seed"])
    prompts = rng.integers(1, cfg.vocab_size, (B, T0)).astype(np.int32)
    fgen = torch.Generator(device=dev).manual_seed(spec["seed"])
    fe = torch.randn((B, cfg.frontend_tokens, cfg.d_model), generator=fgen,
                     device=dev)
    info, _, _ = xattn_serve(eng, dev, spec, prompts, fe, Le, "encdec_path")
    check(info["stepwise"]["launches"]["flash_attention"] == Le,
          f"encdec_path stepwise launches {info['stepwise']['launches']}")
    long = rng.integers(1, cfg.vocab_size, (fb, ft - new)).astype(np.int32)
    ops.reset_launch_counts()
    out, dec = _capture_decode_logits(
        lambda: eng.generate(long, max_new=new, frontend=fe[:fb]))
    long_counts = ops.launch_counts()
    check(long_counts["flash_attention"] == Le,
          f"encdec_path generate() launches {long_counts}")
    seq = torch.from_numpy(np.concatenate([long, out["tokens"]], 1)).to(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fwd, _ = api.forward(eng.params, seq, cfg, frontend=fe[:fb])
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = ops.launch_counts()
    check(fwd_counts["flash_attention"] == Le + 2 * Ld,
          f"encdec_path forward launches {fwd_counts}")
    check(bool(torch.isfinite(fwd).all()) and fwd.shape == (
        fb, ft, cfg.vocab_size), "encdec_path forward logits")
    rep = forward_pick_report(fwd, dec, out["tokens"], ft - new)
    check(rep["near_tie_ok"] and rep["max_abs_err"]
          <= FWD_GAP_SHARE * rep["max_abs_logit"],
          f"encdec_path forward against decode: {rep}")
    other = torch.randn(fe[:fb].shape, generator=fgen, device=dev) + 1.0
    fwd2, _ = api.forward(eng.params, seq, cfg, frontend=other)
    live = (fwd2 - fwd).abs().max().item()
    del fwd, fwd2
    check(live > rep["max_abs_err"], f"encdec_path: another frontend moves "
          f"the logits by {live} only")
    launches = {k: info["launches"][k] + info["stepwise"]["launches"][k]
                + long_counts[k] + fwd_counts[k] for k in fwd_counts}
    prof = profile_generate(eng, dev, "encdec_path", prompts, fe)
    info.update({"phase": "encdec_path", "config": cfg.name,
                 "encoder_layers": Le, "decoder_layers": Ld,
                 "d_model": cfg.d_model,
                 "heads": [cfg.num_heads, cfg.num_kv_heads],
                 "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab_size,
                 "frontend_tokens": cfg.frontend_tokens,
                 "setup_s": setup_s, "setup_peak_memory_bytes": setup_peak,
                 "weight_bytes": wbytes,
                 "flash_per_prefill_token": 0, "flash_per_decode_step": 0,
                 "forward": {"tokens": [fb, ft], "launches": fwd_counts,
                             "seconds": fwd_s,
                             "tokens_per_s": fb * ft / fwd_s,
                             "picks": rep,
                             "other_frontend_max_abs_change": live},
                 "launches_total": launches,
                 "profile": {k: prof[k] for k in (
                     "wall_ms_per_step", "device_ms_per_step",
                     "device_busy_share", "host_ops_per_step")},
                 "card": smi_line})
    emit(info)
    return eng, info


def phase_times_xattn(dev, vinfo, einfo):
    """The flash kernel at the cross-attention families' shapes, each held
    against the plain version first, then timed by CUDA-graph replay: the
    seamless encoder (12 launches, B 4, T 960, 16/16 heads of 64), the VLM's
    cross blocks in a prefill (8 launches, B 4, Tq 127, Tk 1,600, 32/8 heads
    of 128) and in a decode step (8 launches, Tq 1); non-causal.  The
    library call is SDPA on the same tensors (with enable_gqa at 32/8)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    detail, rows = [], {}
    for key, n, case, launched in (
            ("encdec_encoder", einfo["encoder_layers"], XATTN_FLASH_CASES[0],
             einfo["launches_total"]["flash_attention"]),
            ("vision_cross_prefill", vinfo["cross_blocks"],
             XATTN_FLASH_CASES[1],
             vinfo["launches_total"]["flash_attention"]),
            ("vision_cross_decode", vinfo["cross_blocks"],
             XATTN_FLASH_CASES[2],
             vinfo["launches_total"]["flash_attention"])):
        rows[key] = flash_case_times(gen, dev, n, *case, launched, detail,
                                     f"flash_{key}_library")
    emit({"phase": "times", "path": "vision_path, encdec_path", **rows,
          "detail": detail})
    return rows


def flash_case_times(gen, dev, n, label, shape, opts, launched, detail,
                     key):
    """The flash kernel over ``n`` launches at ``shape`` (B, Hq, Hkv, Tq,
    Tk, D) with ``opts``, bf16: the first launch held against the plain
    version, then CUDA-graph replay of the kernel, its eager and plain
    times, the bound and SDPA on the same tensors (``enable_gqa`` where the
    head counts differ; ``is_causal`` for a causal case).  ``launched``:
    the path's count of launches, reported beside."""
    launches = [flash_inputs(gen, dev, *shape, torch.bfloat16)
                for _ in range(n)]
    q0, k0, v0 = launches[0]
    got = ops.attention(q0, k0, v0, **opts).float()
    plain = ref.flash_attention(q0, k0, v0, **opts).float()
    err = (got - plain).abs()
    check(bool((err <= bf16_ulp(plain) + 1e-5).all()),
          f"flash at the {label} shape outside tolerance "
          f"({err.max().item()})")

    def run(fn):
        return lambda: [fn(q, k, v, **opts) for q, k, v in launches]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = shape[1] != shape[2]
    causal = bool(opts.get("causal"))
    window = opts.get("window")
    B, Hq, Hkv, Tq, Tk, D = shape
    bound_ms, bound_by = flash_bound(launches, causal=causal,
                                     windows=[window] * n)
    if window is None:
        lib_kw = dict(is_causal=causal)
        lib_note = f"is_causal={causal}, enable_gqa={gqa}"
    else:
        pos = torch.arange(Tq, device=dev)
        lib_kw = dict(attn_mask=((pos[None, :] <= pos[:, None])
                                 & (pos[None, :] > pos[:, None] - window))
                      [None, None])
        lib_note = (f"enable_gqa={gqa}, a boolean causal {window}-window "
                    "mask")
    return {"unit": f"{label}: {n} launches, B {B}, {Hq}/{Hkv} heads, D {D}, "
                    f"Tq {Tq}, Tk {Tk}, {'causal' if causal else 'non-causal'}"
                    + (f", window {window}" if window else "")
                    + ", bf16, CUDA-graph replay",
            "launches": launched,
            "ms": graph_time_ms(run(ops.attention), iters=20),
            "eager_ms": cuda_time_ms(run(ops.attention), iters=3),
            "plain_ms": graph_time_ms(run(ref.flash_attention), iters=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": yardstick_ms(
                lambda: [sdpa(q, k, v, enable_gqa=gqa, **lib_kw)
                         for q, k, v in launches], 20, detail, key),
            "max_abs_err": err.max().item(),
            "library_note": f"scaled_dot_product_attention({lib_note}) on "
                            "the same tensors"}


def phase_times_tp(dev, tp_info):
    """The kernels at tp_path (d)-(f)'s rank shapes, timed here by one
    process on the whole card (the ranks shared it): the paged kernel over
    one qwen3-moe decode step on a rank (4 launches, 8 slots, 32/2 heads of
    64 at (d)'s lengths 16 tokens into their decode) and the flash kernel
    over (d)'s 256-token prefill (4 launches), (e)'s prefill's causal and
    cross launches (10 and 2), a decode step's cross launches (2) and
    (f)'s encoder (12), each per rank."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    detail, rows = [], {}
    launches = tp_info["launches_rank0"]
    lens = [n - 1 + 16 for n in tp_info["prompt_lens_d"][:MOE_SLOTS]]
    Ld = TP_MOE["layers"]
    paged = paged_step_times(gen, dev, Ld, 32, 2, 64,
                             TP_MOE["max_len"] // MOE_PAGE, lens, detail,
                             "paged_qwen_moe_tp_rank_library")
    paged.update(unit=f"one qwen3-moe decode step on a tp 2 rank: {Ld} "
                      f"launches, {MOE_SLOTS} slots, 32/2 heads, D 64, "
                      f"lengths {lens}, CUDA-graph replay",
                 launches=launches["d"]["paged_decode_attention"])
    rows["paged_qwen_moe_tp_rank"] = paged
    Lv = TP_VISION["layers"]
    G = Lv // get_config(TP_VISION["arch"]).cross_attn_every
    fl_d = launches["d"]["flash_attention"]
    fl_e = launches["e"]["flash_attention"]
    for key, n, (label, shape, opts), launched in (
            ("flash_qwen_moe_tp_rank_prefill", Ld, FLASH_TP_CASES[6], fl_d),
            ("flash_vision_tp_rank_prefill", Lv, FLASH_TP_CASES[7], fl_e),
            ("flash_vision_tp_rank_cross_prefill", G, FLASH_TP_CASES[8],
             fl_e),
            ("flash_vision_tp_rank_cross_decode", G, FLASH_TP_CASES[9], fl_e),
            ("flash_encdec_tp_rank_encoder",
             get_config(TP_ENCDEC["arch"]).num_encoder_layers,
             FLASH_TP_CASES[10], launches["f"]["flash_attention"])):
        rows[key] = flash_case_times(gen, dev, n, label, shape, opts,
                                     launched, detail, key + "_library")
    emit({"phase": "times", "path": "tp_path", **rows, "detail": detail})
    return rows


def run_xattn(dev, smi):
    """The cross-attention phases: the reduced configs card against CPU,
    vision_path, encdec_path, then the flash kernel's times at their
    shapes."""
    phase_reference_xattn(dev)
    eng, vinfo = phase_vision_path(dev, smi)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, einfo = phase_encdec_path(dev, smi)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase_times_xattn(dev, vinfo, einfo)
    emit({"xattn_summary": {
        info["config"]: {**{key: info[key] for key in (
            "decode_steps_per_s", "decode_tokens_per_s",
            "prefill_tokens_per_s", "setup_peak_memory_bytes",
            "peak_memory_bytes", "flash_per_call", "profile")},
            "forward_picks_agree": [info["forward"]["picks"]["argmax_agree"],
                                    info["forward"]["picks"]["n"]]}
        for info in (vinfo, einfo)}, "card": smi})
    return vinfo["launches_total"], einfo["launches_total"], rows


# ---------------------------------------------------------------- training
# train_path (a): stablelm-1.6b at full width and depth through the training
# CLI, as a user would call it; the profiled steps are kept out of the step
# time; (b): examples/train_e2e.py's kill-resume demonstration
TRAIN = dict(arch="stablelm-1.6b", steps=24, batch=8, seq=512)
TRAIN_PROFILED = (20, 21)
TRAIN_E2E = dict(arch="granite-8b", steps=300, batch=16, seq=128, lr=3e-3,
                 every=20, kill_at=150)
# the flash kernel at (a)'s shape (B 8, 32/32 heads of 64, T 512, causal),
# and the scan at rwkv6-7b's heads (B 1, H 64, T 128, D 64)
TRAIN_FLASH_CASE = ("stablelm-1.6b train step", (8, 32, 32, 512, 512, 64),
                    dict(causal=True))
TRAIN_SCAN_SHAPE = (1, 64, 128, 64)


def phase_train_kernels(dev):
    """(c) The kernels' autograd Functions at the training shapes: the
    forward launches the kernel once and equals the wrapper's output, the
    gradients equal the plain version's autograd bit for bit (the backward
    runs the same plain computation on the same inputs); every kernel
    wrapper refuses an operand that requires grad in grad mode; the card's
    float32 ``torch.sqrt`` is correctly rounded (the optimizer relies on
    it).  Then the flash kernel's time over one train step's 24 launches at
    (a)'s shape (CUDA-graph replay) beside its bound, its plain version and
    SDPA, and the cost of the Functions' backward (the plain recompute and
    its gradients), eager."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    bf = torch.bfloat16
    from repro_torch.kernels import rwkv_scan as krw
    label, shape, opts = TRAIN_FLASH_CASE
    q, k, v = flash_inputs(gen, dev, *shape, bf)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(bf)
    ops.reset_launch_counts()
    outs, grads = autograd_grads(lambda *x: ops.attention(*x, **opts),
                                 (q, k, v), (dout,))
    check(ops.launch_counts()["flash_attention"] == 1
          and "FlashAttentionFn" in type(outs[0].grad_fn).__name__,
          "ops.attention in grad mode: one kernel launch through the Function")
    check(torch.equal(outs[0], kfa.flash_attention(q, k, v, **opts)),
          "the flash Function's forward differs from the wrapper's output")
    p_outs, p_grads = autograd_grads(
        lambda *x: ref.flash_attention(*x, **opts), (q, k, v), (dout,))
    flash_same = [bool(torch.equal(a, b)) for a, b in zip(grads, p_grads)]
    flash_err = (outs[0].float() - p_outs[0].float()).abs()
    check(bool((flash_err <= bf16_ulp(p_outs[0].float()) + 1e-5).all()),
          "the flash Function's forward outside phase_flash's bound")
    check(all(flash_same), f"flash dq, dk, dv against the plain version's "
          f"gradients: {flash_same}")
    r, kk, vv, w, u = rwkv_inputs(gen, dev, *TRAIN_SCAN_SHAPE, bf, "model")
    B, H, _, D = TRAIN_SCAN_SHAPE
    douts = (torch.randn(r.shape, generator=gen, device=dev).to(bf),
             torch.randn((B, H, D, D), generator=gen, device=dev))
    ops.reset_launch_counts()
    s_outs, s_grads = autograd_grads(ops.rwkv6, (r, kk, vv, w, u), douts)
    check(ops.launch_counts()["rwkv6_scan"] == 1,
          "ops.rwkv6 in grad mode: one kernel launch through the Function")
    k_out, k_state = krw.rwkv6_scan(r, kk, vv, w, u)
    check(torch.equal(s_outs[0], k_out) and torch.equal(s_outs[1], k_state),
          "the scan Function's forward differs from the wrapper's output")
    p_outs, p_grads = autograd_grads(ref.rwkv6_scan, (r, kk, vv, w, u), douts)
    scan_same = [bool(torch.equal(a, b)) for a, b in zip(s_grads, p_grads)]
    check(all(scan_same) and torch.equal(s_outs[1], p_outs[1]),
          f"scan dr, dk, dv, dw, du against the plain version's: "
          f"{scan_same}")
    # the wrappers refuse an operand that requires grad in grad mode
    qx, xs_, codes = (torch.zeros((8, 64), dtype=torch.int8, device=dev),
                      torch.ones((8, 1), device=dev),
                      torch.zeros((64, 32), dtype=torch.int8, device=dev))
    pc = paged_inputs(gen, dev, B=2, Hq=4, Hkv=2, D=64, ps=16, P=2,
                      lens=[5, 20], qdtype=bf)
    calls = {
        "flash_attention": lambda: kfa.flash_attention(
            q.detach().requires_grad_(True), k, v),
        "rwkv6_scan": lambda: krw.rwkv6_scan(r, kk, vv, w,
                                             u.detach().requires_grad_(True)),
        "w4a8_matmul": lambda: kw.w4a8_matmul(
            qx, xs_.detach().requires_grad_(True), codes,
            torch.ones(32, device=dev), packed=kw.pack_codes(codes)),
        "paged_decode_attention": lambda: run_paged(
            dict(pc, q=pc["q"].detach().requires_grad_(True)),
            kpa.paged_decode_attention)}
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "requires grad" in str(e)
    check(all(refused.values()) and set(refused) == set(ops.KERNELS),
          f"kernel wrappers in grad mode: {refused}")
    x = torch.rand(1 << 22, generator=gen, device=dev) * 100
    sqrt_exact = bool(torch.equal(torch.sqrt(x),
                                  torch.sqrt(x.double()).float()))
    check(sqrt_exact, "float32 torch.sqrt on the card is not correctly "
          "rounded (the optimizer's sqrt relies on it)")
    # times: one train step's 24 launches at (a)'s shape
    L = get_config(TRAIN["arch"]).num_layers
    launches = [flash_inputs(gen, dev, *shape, bf) for _ in range(L)]
    douts_l = [torch.randn(q.shape, generator=gen, device=dev).to(bf)
               for _ in range(L)]

    def run(fn):
        return lambda: [fn(a, b, c, **opts) for a, b, c in launches]

    def plain_backward():
        for (a, b, c), d in zip(launches, douts_l):
            autograd_grads(lambda *t: ref.flash_attention(*t, **opts),
                           (a, b, c), (d,))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    detail = []
    k_ms = graph_time_ms(run(ops.attention), iters=10)
    p_ms = graph_time_ms(run(ref.flash_attention), iters=3)
    lib_ms = yardstick_ms(
        lambda: [sdpa(a, b, c, is_causal=True) for a, b, c in launches], 10,
        detail, "flash_train_library")
    bwd_ms = cuda_time_ms(plain_backward, iters=2, warmup=1)
    sr = rwkv_inputs(gen, dev, *TRAIN_SCAN_SHAPE, bf, "model")
    scan_fwd_ms = cuda_time_ms(lambda: ops.rwkv6(*sr), iters=10)
    scan_bwd_ms = cuda_time_ms(
        lambda: autograd_grads(ref.rwkv6_scan, sr, douts), iters=2, warmup=1)
    bound_ms, bound_by = flash_bound(launches)
    row = {"unit": f"one train step of {TRAIN['arch']}: {L} launches, B 8, "
                   "32/32 heads, D 64, T 512, causal, bf16, CUDA-graph "
                   "replay",
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms,
           "library_note": "scaled_dot_product_attention(is_causal=True) on "
                           "the same tensors",
           "backward_plain_recompute_ms": bwd_ms,
           "max_abs_err": flash_err.max().item()}
    emit({"phase": "train_kernels", "flash": {**row, "grads_bit_identical":
                                              flash_same},
          "scan": {"B_H_T_D": TRAIN_SCAN_SHAPE, "grads_bit_identical":
                   scan_same, "forward_kernel_ms": scan_fwd_ms,
                   "backward_plain_recompute_ms": scan_bwd_ms},
          "refused_grad": refused, "cuda_sqrt_correctly_rounded": sqrt_exact,
          "detail": detail})
    return row


class _Killed(Exception):
    """The preemption of train_path (b)'s first phase."""


def _train_cli(args, record):
    """``repro_torch.launch.train.main(args)`` with each train step timed
    (synchronised) and its loss and flash launches recorded in ``record``,
    the profiled steps of ``record["profile"]`` under torch.profiler; the
    CLI's log lines are kept in ``record["log"]``, not printed."""
    import contextlib
    import io
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_cli
    orig = train_cli.step_mod.make_train_step

    def instrumented(cfg, optcfg, grid=None):
        fn = orig(cfg, optcfg, grid)

        def step(params, opt_state, batch):
            i = len(record["ms"])
            profiled = i in record.get("profile", ())
            if profiled and "prof" not in record:
                record["prof"] = profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA])
                record["prof"].__enter__()
            before = ops.launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(params, opt_state, batch)
            loss = float(out[2]["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            record["ms"].append(dt * 1e3)
            record["loss"].append(loss)
            record["flash"].append(ops.launch_counts()["flash_attention"]
                                   - before)
            if profiled:
                record["prof_wall"] = record.get("prof_wall", 0.0) + dt
                if i == max(record["profile"]):
                    record["prof"].__exit__(None, None, None)
            return out

        return step

    train_cli.step_mod.make_train_step = instrumented
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = train_cli.main(args)
    finally:
        train_cli.step_mod.make_train_step = orig
        record["log"] = buf.getvalue().splitlines()
    return result


def phase_train_path(dev, smi_line):
    """train_path: (a) stablelm-1.6b at full width and depth (24 layers, d
    2048, 32/32 heads of 64, d_ff 5632, vocab 100,352; float32 params from
    a seeded generator on the card, bf16 compute, remat none) through
    ``launch.train.main`` for 24 steps of 8 x 512 tokens, counts set to 0
    just before and read just after: 24 flash launches per step (one per
    layer in the forward, none in the backward) and no other kernel, the
    loss falls; ms per step, train tokens/s, mfu (6 N tokens per step over
    the bf16 peak, N the params outside the input embedding), the device
    busy share over two profiled steps, peak memory.  (b) examples/
    train_e2e.py's demonstration: granite-8b --smoke, batch 16, seq 128, lr
    3e-3, a checkpoint every 20 steps, 300 steps; the first phase is
    preempted (an exception from the data loader) after step 149, the
    restored state equals the saved one bit for bit, the second phase
    resumes with --resume, and the loss drops by more than 0.5 across the
    restart; an uninterrupted 300-step run gives the resumed steps' loss
    gap (the embedding backward's atomics may part them); one save and
    restore with int8 moments through the Python API."""
    import shutil
    import threading
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data import pipeline as tpipe
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    # (a)
    rec = {"ms": [], "loss": [], "flash": [], "profile": TRAIN_PROFILED}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = _train_cli(["--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]),
                      "--batch", str(TRAIN["batch"]), "--seq",
                      str(TRAIN["seq"]), "--device", "cuda"], rec)
    wall_a = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = {"w4a8_matmul": 0, "paged_decode_attention": 0, "rwkv6_scan": 0,
            "flash_attention": L * TRAIN["steps"]}
    check(counts == want, f"train_path (a) launches {counts} != {want}")
    check(rec["flash"] == [L] * TRAIN["steps"],
          f"train_path (a) flash launches per step {rec['flash']}")
    check(out["steps"] == TRAIN["steps"]
          and all(np.isfinite(rec["loss"]))
          and out["last_loss"] < out["first_loss"],
          f"train_path (a): the loss did not fall: {out}")
    timed = [ms for i, ms in enumerate(rec["ms"])
             if i >= 2 and i not in TRAIN_PROFILED]
    ms = float(np.median(timed))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    n_params = cfg.param_count()
    n_flops = n_params - cfg.vocab_size * cfg.d_model
    prof = profile_summary(rec["prof"], rec["prof_wall"],
                           len(TRAIN_PROFILED), "train_path")
    flash_dev = sum(
        getattr(ev, "self_device_time_total", 0.0)
        for ev in rec["prof"].key_averages()
        if str(getattr(ev, "device_type", "")).endswith("CUDA")
        and "flash" in ev.key) / 1e3 / len(TRAIN_PROFILED)
    info_a = {"config": cfg.name, "layers": L, "params": n_params,
              "steps": out["steps"], "batch": TRAIN["batch"],
              "seq": TRAIN["seq"], "first_loss": out["first_loss"],
              "last_loss": out["last_loss"], "ms_per_step": ms,
              "ms_per_step_min_max": [min(timed), max(timed)],
              "first_steps_ms": rec["ms"][:2],
              "train_tokens_per_s": tokens / (ms / 1e3),
              "model_flops_per_step": 6 * n_flops * tokens,
              "mfu": 6 * n_flops * tokens / (ms / 1e3) / BF16_FLOPS_PER_S,
              "device_busy_share": prof["device_busy_share"],
              "profiled_device_ms_per_step": prof["device_ms_per_step"],
              "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
              "flash_device_ms_per_step": flash_dev,
              "top_kernels": prof["top_kernels"],
              "host_ops_per_step": prof["host_ops_per_step"],
              "peak_memory_bytes": peak, "wall_s": wall_a,
              "launches": counts, "log_tail": rec["log"][-3:]}
    emit({"phase": "train_path", "run": "a", **info_a, "card": smi_line})
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    e2e = TRAIN_E2E
    root = build.BUILD_DIR / "train_e2e"
    shutil.rmtree(root, ignore_errors=True)

    def e2e_args(d, *extra):
        return ["--arch", e2e["arch"], "--smoke", "--steps",
                str(e2e["steps"]), "--batch", str(e2e["batch"]), "--seq",
                str(e2e["seq"]), "--lr", str(e2e["lr"]), "--ckpt-dir",
                str(root / d), "--ckpt-every", str(e2e["every"]), "--device",
                "cuda", *extra]

    saved = {}
    orig_save, orig_next = CheckpointManager.save, tpipe.DataLoader.__next__

    def recording_save(self, step, tree, metadata=None, **kw):
        saved[step] = {k: t.detach().cpu().clone()
                       for k, t in topt.leaves(tree)}
        return orig_save(self, step, tree, metadata, **kw)

    def preempted(self):
        if self.step == e2e["kill_at"]:
            raise _Killed
        return orig_next(self)

    t0 = time.perf_counter()
    rec1 = {"ms": [], "loss": [], "flash": []}
    CheckpointManager.save = recording_save
    tpipe.DataLoader.__next__ = preempted
    try:
        _train_cli(e2e_args("cut"), rec1)
        check(False, "train_path (b): the first phase was not preempted")
    except _Killed:
        pass
    finally:
        CheckpointManager.save = orig_save
        tpipe.DataLoader.__next__ = orig_next
    for t in threading.enumerate():            # the in-flight async save
        if "_write_async" in t.name:
            t.join()
    mgr = CheckpointManager(str(root / "cut"))
    last = mgr.latest_step()
    ecfg = dataclasses.replace(get_config(e2e["arch"]).reduced())
    like = {"params": api.init_params(ecfg, torch.Generator(dev).manual_seed(
        SEED + 51), device=dev)}
    like["opt"] = topt.init_state(like["params"], topt.AdamWConfig())
    restored, meta = mgr.restore(like)
    same = all(torch.equal(t.cpu(), saved[last][k]) and t.device == dev
               for k, t in topt.leaves(restored))
    check(last == e2e["kill_at"] - 11 and meta["step"] == last and same,
          f"train_path (b): restored step {last} {meta} bit-identical "
          f"{same}")
    rec2 = {"ms": [], "loss": [], "flash": []}
    r2 = _train_cli(e2e_args("cut", "--resume"), rec2)
    drop = rec1["loss"][0] - r2["last_loss"]
    check(r2["steps"] == e2e["steps"] - last - 1 and drop > 0.5,
          f"train_path (b): loss {rec1['loss'][0]} -> {r2['last_loss']} "
          f"(drop {drop}) across the restart")
    rec3 = {"ms": [], "loss": [], "flash": []}
    r3 = _train_cli(e2e_args("whole"), rec3)
    gaps = np.abs(np.asarray(rec2["loss"])
                  - np.asarray(rec3["loss"][last + 1:]))
    pre = np.abs(np.asarray(rec1["loss"][:last + 1])
                 - np.asarray(rec3["loss"][:last + 1]))
    # int8 moments through the Python API: three steps, a save, a restore
    qcfg = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=4,
                            quantize_moments=True)
    qp = api.init_params(ecfg, torch.Generator(dev).manual_seed(SEED + 52),
                         device=dev)
    qs = topt.init_state(qp, qcfg)
    qstep = tstep.make_train_step(ecfg, qcfg)
    dcfg = tpipe.DataConfig(vocab_size=ecfg.vocab_size, seq_len=e2e["seq"],
                            global_batch=e2e["batch"], seed=SEED)
    for i in range(3):
        qp, qs, qm = qstep(qp, qs, tpipe.global_batch_at_step(dcfg, i))
    qmgr = CheckpointManager(str(root / "q8"), keep=1)
    qmgr.save(2, {"params": qp, "opt": qs})
    qlike = {"params": api.init_params(ecfg, torch.Generator(dev).manual_seed(
        SEED + 53), device=dev)}
    qlike["opt"] = topt.init_state(qlike["params"], qcfg)
    qback, _ = qmgr.restore(qlike)
    q_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        topt.leaves(qback), topt.leaves({"params": qp, "opt": qs})))
    check(q_same and isinstance(qback["opt"]["m"]["embed"], topt.QMoment),
          "train_path (b): the int8-moment state did not restore bit for "
          "bit")
    info_b = {"config": ecfg.name, "first_phase_steps": len(rec1["loss"]),
              "preempted_before_step": e2e["kill_at"],
              "restored_step": last, "restored_bit_identical": same,
              "resumed_steps": r2["steps"], "first_loss": rec1["loss"][0],
              "last_loss": r2["last_loss"], "drop": drop,
              "uninterrupted_last_loss": r3["last_loss"],
              "resumed_vs_uninterrupted_max_gap": float(gaps.max()),
              "resumed_vs_uninterrupted_last_gap": float(gaps[-1]),
              "first_phase_vs_uninterrupted_max_gap": float(pre.max()),
              "first_phase_bit_identical": bool((pre == 0).all()),
              "ms_per_step": float(np.median(rec3["ms"][2:])),
              "q8_restored_bit_identical": q_same,
              "q8_loss_after_3_steps": float(qm["loss"]),
              "seconds": time.perf_counter() - t0}
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_path", "run": "b", **info_b, "card": smi_line})
    seconds = time.perf_counter() - t_phase
    check(seconds <= 90.0 * 1.2, f"train_path took {seconds:.1f} s")
    return {"launches": counts, "a": info_a, "b": info_b,
            "seconds": seconds}


# ------------------------------------------------------ distributed training
# dist_train_path: granite-8b (arXiv:2405.04324) at full width (d 4096, 32/8
# heads of 128, d_ff 14,336, vocab 49,152) and DIST["layers"] of its 36
# layers on a (2, 2) grid of four gloo ranks sharing the card; each rank's
# flash launch is its 16/4 heads over its 4 batch rows.  The ranks' gloo
# traffic grows with the layers: at 4 the phase took 69 s on one host and
# 97 s on a host 1.3x slower, so it runs 3
DIST_SLACK = 1.2                   # host variance over the phase's 90 s
DIST = dict(arch="granite-8b", layers=3, shape=(2, 2), steps=4, batch=8,
            seq=512, profiled=2, lr=3e-4, warmup=10)
DIST_FLASH_CASE = ("granite-8b grid rank", (4, 16, 4, 512, 512, 128),
                   dict(causal=True))
# the grid's step 1 gradient norm and step 2 loss against the one-device
# step's (step 2's loss measured 4.5e-5 apart at 3 layers: bf16 sums in
# other orders)
DIST_ONE_DEVICE_RTOL = 1e-3
DIST_WIDTH = 4096                  # (b)'s wo leaf and (c)'s stage width
DIST_PIPE = dict(microbatches=8, mb=4)


def dist_cfg():
    cfg = get_config(DIST["arch"])
    return dataclasses.replace(
        cfg, num_layers=DIST["layers"],
        parallel=dataclasses.replace(cfg.parallel, remat="none"))


def dist_batches(cfg, n):
    """The data pipeline's first ``n`` global batches (mask all ones, as the
    training CLI feeds them)."""
    from repro_torch.data import pipeline as tpipe
    dcfg = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=DIST["seq"],
                            global_batch=DIST["batch"], seed=SEED)
    out = []
    for i in range(n):
        b = tpipe.global_batch_at_step(dcfg, i)
        b["mask"] = np.ones_like(b["labels"], np.float32)
        out.append(b)
    return out


def dist_rank_train(grid, dev):
    """(a) on this rank: the grid's train step (``make_train_step(grid=)``,
    as ``launch.train`` builds it, with its warmup of 10 steps and the
    optimizer's default lr, 3e-4: at 1e-3 this width's loss jumps by half
    within the warmup, both ways) on the rank's blocks of the seeded
    float32 params: DIST["steps"] steps with the counts set to 0 just
    before and read just after, the last DIST["profiled"] of them under
    torch.profiler.  Rank 0 first computes ``api.loss_fn`` of the whole
    params on step 1's global batch in this one process."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import runtime
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = dist_cfg()
    n = DIST["steps"]
    batches = dist_batches(cfg, n)
    marks, t0 = {}, time.perf_counter()

    def mark(name):
        marks[name] = time.perf_counter() - t0

    step = tstep.make_train_step(cfg, dist_opt(), grid)
    lay = step.layout
    whole = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 60), device=dev)
    torch.cuda.synchronize()
    mark("init_s")
    out = {}
    if grid.rank == 0:
        with torch.no_grad():
            out["one_process_loss"] = float(api.loss_fn(
                whole, tstep.batch_to(batches[0], dev), cfg)[1]["loss"])
    mark("one_process_loss_s")
    with torch.no_grad():
        params = lay.shard_tree(whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    state = topt.init_state(params, dist_opt(), layout=lay)
    torch.cuda.synchronize()
    mark("shard_s")
    cuts = lay.flat_cuts()
    dp, tp = grid.shape
    bad = []
    for k, t in topt.leaves(params):
        want = list(lay.shapes[k])
        m, d = cuts[k]
        if m is not None:
            want[m] //= tp
        if d is not None:
            want[d] //= dp
        if list(t.shape) != want:
            bad.append((k, list(t.shape), want))
    check(not bad, f"dist_train_path (a) rank {grid.rank}: leaves not cut as "
          f"train_param_cuts says: {bad[:4]}")
    out["setup_s"] = marks
    out["rank_params"] = sum(t.numel() for _, t in topt.leaves(params))
    out["cut_leaves"] = {k: list(t.shape) for k, t in topt.leaves(params)
                         if k in ("embed", "lm_head", "blocks/attn/wq",
                                  "blocks/attn/wo", "blocks/mlp/w1",
                                  "blocks/mlp/w2")}
    torch.cuda.reset_peak_memory_stats()
    grid.world.barrier()
    runtime.collective_stats(reset=True)
    ops.reset_launch_counts()
    steps, prof, wall = [], None, 0.0
    for i in range(n):
        if i == n - DIST["profiled"]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        flash0 = ops.launch_counts()["flash_attention"]
        c0 = runtime.COLLECTIVES["seconds"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if prof is not None:
            wall += dt
        steps.append({"ms": dt * 1e3, "loss": loss,
                      "grad_norm": float(m["grad_norm"]),
                      "collective_s": runtime.COLLECTIVES["seconds"] - c0,
                      "flash": ops.launch_counts()["flash_attention"]
                      - flash0, "profiled": prof is not None})
    prof.__exit__(None, None, None)
    out["launches"] = ops.launch_counts()
    out["collectives"] = runtime.collective_stats()
    out["steps"] = steps
    s = profile_summary(prof, wall, DIST["profiled"], "dist_train_path")
    out["profile"] = {k: s[k] for k in (
        "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
        "host_ops_per_step", "top_kernels")}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_opt():
    from repro_torch.train import optimizer as topt
    return topt.AdamWConfig(lr=DIST["lr"], warmup_steps=DIST["warmup"],
                            total_steps=DIST["steps"])


def dist_one_device(dev, n=2):
    """The one-device train step on the same params and batches: its first
    ``n`` steps' losses and gradient norms, which the grid's are held to
    (past step 1 the two part only by the row cuts' and the data split's
    sum orders)."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = dist_cfg()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 60), device=dev)
    state = topt.init_state(params, dist_opt())
    step = tstep.make_train_step(cfg, dist_opt())
    losses, norms = [], []
    for b in dist_batches(cfg, n):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms


def dist_rank_psum(grid, dev):
    """(b) on this rank: ``compressed_psum_mean`` over its "data" subgroup
    on a (4096, 4096) float32 leaf (granite-8b's ``wo``), each data rank's
    input drawn from one seed, against a one-process replay of the same
    arithmetic on every data rank's input (bit for bit) and the exact mean
    (within the reference test's 2 max|x| / 127)."""
    from repro_torch.distributed import collectives, runtime
    data, n, block = grid.data, grid.data.size, 256
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    xs = torch.randn((n, DIST_WIDTH, DIST_WIDTH), generator=gen, device=dev)
    xs *= torch.exp(torch.empty_like(xs).uniform_(-4, 1, generator=gen))
    mine = xs[data.rank].clone()
    got = collectives.compressed_psum_mean({"wo": mine}, data, block)["wo"]
    # the replay: every rank's blocks, local scales, their max, the codes,
    # the int32 sum, the dequantized mean
    blocks = xs.reshape(n, -1, block)
    scale = torch.clamp_min(blocks.abs().amax(dim=2, keepdim=True)
                            * np.float32(1.0 / 127.0), 1e-20).amax(dim=0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    q_sum = q.to(torch.int32).sum(dim=0)
    replay = ((q_sum.to(torch.float32) * scale).reshape(-1)
              .reshape(DIST_WIDTH, DIST_WIDTH) / n)
    exact = xs.mean(dim=0)
    err = (got - exact).abs().max().item()
    bound = 2 * xs.abs().max().item() / 127
    same = bool(torch.equal(got, replay))
    check(same, f"dist_train_path (b) rank {grid.rank}: the int8 reduction "
          "differs from the one-process replay")
    check(err <= bound, f"dist_train_path (b): error {err} over the bound "
          f"{bound}")
    grid.world.barrier()
    c0 = runtime.COLLECTIVES["seconds"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        collectives.compressed_psum_mean({"wo": mine}, data, block)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 3 * 1e3
    return {"shape": [DIST_WIDTH, DIST_WIDTH], "ranks": n, "block": block,
            "bit_identical_to_replay": same, "max_abs_err_vs_mean": err,
            "bound": bound, "wall_ms_per_call": ms,
            "collective_ms_per_call":
                (runtime.COLLECTIVES["seconds"] - c0) / 3 * 1e3}


def dist_rank_pipe(grid, dev):
    """(c) on this rank: ``pipeline_apply`` over the four ranks as a "pipe"
    group (rank s holds stage s's weight), stage ``tanh(x @ W_s)`` in
    float32 at width 4096, against the sequential application of the four
    stages in this process (bit for bit)."""
    from repro_torch.distributed import pipeline
    world = grid.world
    S, M, mb = world.size, DIST_PIPE["microbatches"], DIST_PIPE["mb"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)
    ws = torch.randn((S, DIST_WIDTH, DIST_WIDTH), generator=gen,
                     device=dev) / DIST_WIDTH ** 0.5
    x = torch.randn((M, mb, DIST_WIDTH), generator=gen, device=dev)

    def stage(w, h):
        return torch.tanh(h @ w)

    run = pipeline.pipeline_apply(world, stage, M)
    got = run(ws[world.rank], x)
    seq = []
    for i in range(M):
        h = x[i]
        for w in ws:
            h = stage(w, h)
        seq.append(h)
    seq = torch.stack(seq)
    same = bool(torch.equal(got, seq))
    check(same, f"dist_train_path (c) rank {grid.rank}: the pipeline differs "
          "from the sequential application")
    world.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(ws[world.rank], x)
    torch.cuda.synchronize()
    return {"stages": S, "microbatches": M, "mb": mb, "width": DIST_WIDTH,
            "bit_identical_to_sequential": same,
            "wall_ms_per_call": (time.perf_counter() - t) * 1e3,
            "bubble_fraction": pipeline.bubble_fraction(S, M)}


def dist_rank(grid, t_spawn):
    """One rank of dist_train_path: (a), (b), (c) in turn.  Every check
    raises here, which fails the run."""
    dev = grid.device
    exact_matmuls()
    t_rank = time.perf_counter()
    res = {"rank": grid.rank, "data_rank": grid.data.rank,
           "model_rank": grid.model.rank, "start_s": time.time() - t_spawn,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    res["a"] = dist_rank_train(grid, dev)
    res["a_s"] = time.perf_counter() - t_rank
    res["b"] = dist_rank_psum(grid, dev)
    res["c"] = dist_rank_pipe(grid, dev)
    res["wall_s"] = time.perf_counter() - t_rank
    return res


def phase_dist_train_path(dev, smi_line):
    """dist_train_path: (a) granite-8b at full width and DIST["layers"]
    layers trained by a (2, 2) grid of four gloo ranks on the one card
    (FSDP over "data", Megatron's cuts over "model"; float32 params, bf16
    compute, remat none, global batches of 8 x 512, 4 rows a data rank):
    DIST["layers"] flash launches per rank per step and no other kernel,
    every rank's losses the same, step 1's loss within a relative 1e-3 of
    ``api.loss_fn`` on the whole params in one process, step 1's gradient
    norm and step 2's loss (the first update's) within a relative
    ``DIST_ONE_DEVICE_RTOL`` of the one-device train step's on the same
    params and batches (``dist_one_device``), the loss falls;
    ms per step and train tokens/s (the median of the steps after two,
    the last two profiled), per rank the seconds inside collectives, the
    busy share over the two profiled steps and the peak memory, and the
    peaks' sum.  (b) the int8 reduction over the "data"
    subgroups, (c) the pipeline over the four ranks.  The ranks start as
    ``launch.train --dp 2 --tp 2`` starts them (``runtime.spawn``)."""
    from repro_torch.distributed import runtime
    t0 = time.perf_counter()
    backend, devices = runtime.plan(DIST["shape"], dev)
    ranks = runtime.spawn(dist_rank, DIST["shape"], (time.time(),),
                          backend=backend, devices=devices, timeout=600)
    spawn_s = time.perf_counter() - t0
    L, n = DIST["layers"], DIST["steps"]
    losses = [s["loss"] for s in ranks[0]["a"]["steps"]]
    norms = [s["grad_norm"] for s in ranks[0]["a"]["steps"]]
    one = ranks[0]["a"]["one_process_loss"]
    rel = abs(losses[0] - one) / abs(one)
    t1 = time.perf_counter()
    one_losses, one_norms = dist_one_device(dev)
    one_device_s = time.perf_counter() - t1
    rel_loss2 = abs(losses[1] - one_losses[1]) / abs(one_losses[1])
    rel_norm1 = abs(norms[0] - one_norms[0]) / abs(one_norms[0])
    # the median of the steps after two (the last two profiled)
    ms = [float(np.median([s["ms"] for s in r["a"]["steps"][2:]]))
          for r in ranks]
    step_ms = max(ms)
    tokens = DIST["batch"] * DIST["seq"]
    per_rank = []
    for r, m in zip(ranks, ms):
        a = r["a"]
        per_rank.append({
            "rank": r["rank"], "data_rank": r["data_rank"],
            "model_rank": r["model_rank"], "start_s": r["start_s"],
            "wall_s": r["wall_s"], "a_s": r["a_s"],
            "setup_s": a["setup_s"], "rank_params": a["rank_params"],
            "cut_leaves": a["cut_leaves"], "ms_per_step": m,
            "steps_ms": [s["ms"] for s in a["steps"]],
            "collective_s_per_step": float(np.median(
                [s["collective_s"] for s in a["steps"][2:]])),
            "collective_calls_per_step": a["collectives"]["calls"] / n,
            "profile": a["profile"], "peak_memory_bytes":
                a["peak_memory_bytes"], "b": r["b"], "c": r["c"]})
    cfg = dist_cfg()
    seconds = time.perf_counter() - t0
    info = {"phase": "dist_train_path", "config": cfg.name, "layers": L,
            "grid": list(DIST["shape"]), "backend": backend,
            "devices": devices, "params": cfg.param_count(),
            "steps": n, "batch": DIST["batch"], "seq": DIST["seq"],
            "losses": losses, "grad_norms": norms,
            "one_process_loss": one, "step1_loss_rel_diff": rel,
            "one_device_losses": one_losses,
            "one_device_grad_norms": one_norms,
            "step2_loss_rel_diff": rel_loss2,
            "step1_grad_norm_rel_diff": rel_norm1,
            "one_device_rtol": DIST_ONE_DEVICE_RTOL,
            "one_device_s": one_device_s,
            "ms_per_step": step_ms,
            "train_tokens_per_s": tokens / (step_ms / 1e3),
            "rank_alloc_conf": ranks[0]["alloc_conf"],
            "launches_per_rank": ranks[0]["a"]["launches"],
            "peak_memory_sum_bytes": sum(r["a"]["peak_memory_bytes"]
                                         for r in ranks),
            "ranks": per_rank, "b": {"bit_identical": all(
                r["b"]["bit_identical_to_replay"] for r in ranks)},
            "c": {"bit_identical": all(r["c"]["bit_identical_to_sequential"]
                                       for r in ranks),
                  "bubble_fraction": ranks[0]["c"]["bubble_fraction"]},
            "spawn_s": spawn_s, "seconds": seconds, "card": smi_line}
    emit(info)
    want = {"w4a8_matmul": 0, "paged_decode_attention": 0, "rwkv6_scan": 0,
            "flash_attention": L * n}
    for r in ranks:
        a = r["a"]
        check(a["launches"] == want, f"dist_train_path (a) rank {r['rank']}:"
              f" launches {a['launches']} != {want}")
        check([s["flash"] for s in a["steps"]] == [L] * n,
              f"dist_train_path (a) rank {r['rank']}: flash per step")
        check([s["loss"] for s in a["steps"]] == losses,
              "dist_train_path (a): the ranks' losses differ")
    check(rel <= 1e-3, f"dist_train_path (a): step 1's loss {losses[0]} vs "
          f"one process's {one} (relative {rel})")
    check(rel_norm1 <= DIST_ONE_DEVICE_RTOL,
          f"dist_train_path (a): step 1's gradient norm {norms[0]} vs the "
          f"one-device step's {one_norms[0]} (relative {rel_norm1})")
    check(rel_loss2 <= DIST_ONE_DEVICE_RTOL,
          f"dist_train_path (a): step 2's loss {losses[1]} vs the "
          f"one-device step's {one_losses[1]} (relative {rel_loss2})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"dist_train_path (a): the loss did not fall: {losses}")
    check(seconds <= 90.0 * DIST_SLACK,
          f"dist_train_path took {seconds:.1f} s")
    return {"launches": ranks[0]["a"]["launches"], "seconds": seconds,
            "losses": losses}


def phase_times_dist(dev, dist_info):
    """The flash kernel at a dist_train_path rank's shape (B 4, 16/4 heads of
    128, T 512, causal, bf16) over one step's DIST["layers"] launches:
    kernel (CUDA-graph replay), plain version, bound and SDPA with
    enable_gqa."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    detail = []
    label, shape, opts = DIST_FLASH_CASE
    ls = [flash_inputs(gen, dev, *shape, torch.bfloat16)
          for _ in range(DIST["layers"])]

    def run(fn):
        return lambda: [fn(q, k, v, **opts) for q, k, v in ls]

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound_ms, bound_by = flash_bound(ls)
    row = {"unit": f"one {label} step: {DIST['layers']} launches, B 4, 16/4 "
                   "heads, D 128, T 512, causal, bf16, CUDA-graph replay",
           "ms": graph_time_ms(run(ops.attention), iters=20),
           "plain_ms": graph_time_ms(run(ref.flash_attention), iters=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": yardstick_ms(
               lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True)
                        for q, k, v in ls], 20, detail, "flash_dist_library"),
           "library_note": "scaled_dot_product_attention(is_causal=True, "
                           "enable_gqa=True) on the same tensors",
           "launches": dist_info["launches"]["flash_attention"]}
    emit({"phase": "times", "path": "dist_train_path", "flash": row,
          "detail": detail})
    return row


# ---------------------------------------------- tensor-parallel training
# tp_train_path: the families beyond the lm family's dense text configs
# (rwkv, hymba, the encoder-decoder, the VLM, a MoE config), each at full
# width on a (1, 2) grid of two gloo ranks sharing the card
# (Megatron's cuts over "model", a MoE config's experts cut over it; float32
# params, bf16 compute, remat "none"), each config in turn, each released
# before the next.  Depth is cut for memory and time; per config: its
# layers (seamless: decoder and encoder), the global batch and length, and
# the flash and scan launches a rank makes per step (all in the forward,
# through the kernels' Functions; the backward recomputes the plain
# version).  rwkv6-7b's scan runs at 32 of its 64 heads a rank; hymba-1.5b's
# 25/5 heads do not divide by 2, so every rank runs every head (window
# 1,024, bound at T 2,048), and its selective scan takes the config's
# associative form (the JAX package's log-depth scan, ``ssm_scan``): the
# sequential form's 2,048 steps took 16-20 s a step a rank; the VLM's 5
# layers hold its first cross block; phi3.5-moe runs 1 of its 32 layers
# (at 2 a rank's experts, moments and the optimizer's float32 temporaries
# took 35 GB, and the two ranks ran out of the card's memory); rwkv6-7b
# runs 1 (at 2 its rank took 32 s, 15 of them in the profile of its plain
# scan backward's small ops).  ``grad_rtol``: step 1's grad norm against
# the one-device step's where DIST_ONE_DEVICE_RTOL is out of reach in bf16:
# hymba's one-device norm itself moves by 1.2e-3 when its projections are
# rounded once from float32 GEMMs instead (``tp_train_rounding_probe``,
# reported), and the grid's partial sums round as differently
TP_TRAIN_PROBE = ("hymba-1.5b",)
TP_TRAIN = {
    "rwkv6-7b": dict(layers=1, batch=4, seq=256, flash=0, scan=1),
    "hymba-1.5b": dict(layers=4, batch=2, seq=2048, flash=4, scan=0,
                       ssm_scan="associative", grad_rtol=5e-3),
    "seamless-m4t-medium": dict(layers=2, encoder_layers=2, batch=4,
                                seq=256, flash=6, scan=0),
    "llama-3.2-vision-11b": dict(layers=5, batch=4, seq=256, flash=6,
                                 scan=0),
    "phi3.5-moe-42b-a6.6b": dict(layers=1, batch=4, seq=256, flash=1,
                                 scan=0),
}
TP_TRAIN_SHAPE = (1, 2)
TP_TRAIN_STEPS = 3
TP_TRAIN_SECONDS = 60.0            # on a host like the faster one
# the kernels at a tp_train_path rank's shapes (B, Hq, Hkv, Tq, Tk, D):
# (key, config, launches a rank a step, label, shape, options)
TP_TRAIN_FLASH = [
    ("flash_moe_tp_train_rank", "phi3.5-moe-42b-a6.6b", 1,
     "phi3.5-moe tp-train rank", (4, 16, 4, 256, 256, 128),
     dict(causal=True)),
    ("flash_vision_tp_train_rank", "llama-3.2-vision-11b", 5,
     "llama-3.2-vision-11b tp-train rank", (4, 16, 4, 256, 256, 128),
     dict(causal=True)),
    ("flash_vision_tp_train_rank_cross", "llama-3.2-vision-11b", 1,
     "llama-3.2-vision-11b tp-train rank cross", (4, 16, 4, 256, 1600, 128),
     dict(causal=False)),
    ("flash_encdec_tp_train_rank_encoder", "seamless-m4t-medium", 2,
     "seamless-m4t-medium tp-train rank encoder", (4, 8, 8, 960, 960, 64),
     dict(causal=False)),
    ("flash_encdec_tp_train_rank_self", "seamless-m4t-medium", 2,
     "seamless-m4t-medium tp-train rank decoder", (4, 8, 8, 256, 256, 64),
     dict(causal=True)),
    ("flash_encdec_tp_train_rank_cross", "seamless-m4t-medium", 2,
     "seamless-m4t-medium tp-train rank cross", (4, 8, 8, 256, 960, 64),
     dict(causal=False)),
    ("flash_hymba_tp_train_rank", "hymba-1.5b", 4,
     "hymba-1.5b tp-train rank (every head)", (2, 25, 5, 2048, 2048, 64),
     dict(causal=True, window=1024)),
]
TP_TRAIN_SCAN = (4, 32, 256, 64)   # rwkv6-7b's rank: B 4, H 32, T 256, D 64
TP_TRAIN_SCAN_CASE = ("rwkv6-7b tp-train rank", TP_TRAIN_SCAN,
                      torch.bfloat16, "model")


def tp_train_flash_cases():
    """TP_TRAIN_FLASH as phase_flash's cases, each shape once (the seamless
    encoder's is also FLASH_TP_CASES')."""
    out, seen = [], {(shape, tuple(sorted(opts.items())))
                     for _, shape, opts in FLASH_TP_CASES}
    for _, _, _, label, shape, opts in TP_TRAIN_FLASH:
        key = (shape, tuple(sorted(opts.items())))
        if key not in seen:
            seen.add(key)
            out.append((label, shape, opts))
    return out


def phase_tp_train_grads(dev):
    """The kernels' autograd Functions at every tp_train_path rank shape, as
    train_kernels holds them at theirs: one launch in grad mode through the
    Function, its forward the wrapper's output, the gradients the plain
    version's autograd bit for bit."""
    from repro_torch.kernels import rwkv_scan as krw
    gen = torch.Generator(device=dev).manual_seed(SEED + 72)
    bf = torch.bfloat16
    rows = []
    seen = set()
    for _, _, _, label, shape, opts in TP_TRAIN_FLASH:
        key = (shape, tuple(sorted(opts.items())))
        if key in seen:
            continue
        seen.add(key)
        q, k, v = flash_inputs(gen, dev, *shape, bf)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(bf)
        ops.reset_launch_counts()
        outs, grads = autograd_grads(lambda *x: ops.attention(*x, **opts),
                                     (q, k, v), (dout,))
        one = (ops.launch_counts()["flash_attention"] == 1
               and "FlashAttentionFn" in type(outs[0].grad_fn).__name__)
        fwd = bool(torch.equal(outs[0], kfa.flash_attention(q, k, v,
                                                            **opts)))
        _, p_grads = autograd_grads(
            lambda *x: ref.flash_attention(*x, **opts), (q, k, v), (dout,))
        same = [bool(torch.equal(a, b)) for a, b in zip(grads, p_grads)]
        rows.append({"kernel": "flash", "case": label, "shape": shape,
                     **opts, "one_launch": one, "forward_is_wrapper": fwd,
                     "grads_bit_identical": same})
        del q, k, v, dout, outs, grads, p_grads
    r, kk, vv, w, u = rwkv_inputs(gen, dev, *TP_TRAIN_SCAN, bf, "model")
    B, H, _, D = TP_TRAIN_SCAN
    douts = (torch.randn(r.shape, generator=gen, device=dev).to(bf),
             torch.randn((B, H, D, D), generator=gen, device=dev))
    ops.reset_launch_counts()
    s_outs, s_grads = autograd_grads(ops.rwkv6, (r, kk, vv, w, u), douts)
    one = ops.launch_counts()["rwkv6_scan"] == 1
    k_out, k_state = krw.rwkv6_scan(r, kk, vv, w, u)
    fwd = bool(torch.equal(s_outs[0], k_out)
               and torch.equal(s_outs[1], k_state))
    _, p_grads = autograd_grads(ref.rwkv6_scan, (r, kk, vv, w, u), douts)
    same = [bool(torch.equal(a, b)) for a, b in zip(s_grads, p_grads)]
    rows.append({"kernel": "rwkv6_scan", "case": TP_TRAIN_SCAN_CASE[0],
                 "shape": TP_TRAIN_SCAN, "one_launch": one,
                 "forward_is_wrapper": fwd, "grads_bit_identical": same})
    emit({"phase": "tp_train_grads", "cases": rows})
    for row in rows:
        check(row["one_launch"] and row["forward_is_wrapper"]
              and all(row["grads_bit_identical"]),
              f"tp_train_grads: {row}")


def tp_train_cfg(arch):
    spec = TP_TRAIN[arch]
    cfg = get_config(arch)
    kw = {"num_layers": spec["layers"]}
    for key, name in (("encoder_layers", "num_encoder_layers"),
                      ("ssm_scan", "ssm_scan")):
        if key in spec:
            kw[name] = spec[key]
    return dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat="none"), **kw)


def tp_train_batches(cfg, spec, n):
    """The data pipeline's first ``n`` global batches at the config's batch
    and length (mask all ones, a VLM's or seamless's frontend included, as
    the training CLI feeds them)."""
    from repro_torch.data import pipeline as tpipe
    dcfg = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                            global_batch=spec["batch"], seed=SEED,
                            frontend_tokens=cfg.frontend_tokens,
                            d_model=cfg.d_model)
    out = []
    for i in range(n):
        b = tpipe.global_batch_at_step(dcfg, i)
        b["mask"] = np.ones_like(b["labels"], np.float32)
        out.append(b)
    return out


def tp_train_opt():
    from repro_torch.train import optimizer as topt
    return topt.AdamWConfig(lr=DIST["lr"], warmup_steps=DIST["warmup"],
                            total_steps=TP_TRAIN_STEPS)


def tp_train_family(grid, dev, arch):
    """One config on this rank: the grid's train step on the rank's blocks
    of the seeded float32 params, TP_TRAIN_STEPS steps with the counts set
    to 0 just before and read just after, the last under torch.profiler;
    rank 0 first computes ``api.loss_fn`` of the whole params on step 1's
    global batch in this one process.  A MoE config's drop log is kept."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import runtime
    from repro_torch.models import moe
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = tp_train_cfg(arch)
    spec = TP_TRAIN[arch]
    t0 = time.perf_counter()
    batches = tp_train_batches(cfg, spec, TP_TRAIN_STEPS)
    step = tstep.make_train_step(cfg, tp_train_opt(), grid)
    lay = step.layout
    whole = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 70), device=dev)
    out = {}
    if grid.rank == 0:
        with torch.no_grad():
            out["one_process_loss"] = float(api.loss_fn(
                whole, tstep.batch_to(batches[0], dev), cfg)[1]["loss"])
    with torch.no_grad():
        params = lay.shard_tree(whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    state = topt.init_state(params, tp_train_opt(), layout=lay)
    cuts = lay.flat_cuts()
    bad = []
    for k, t in topt.leaves(params):
        want = list(lay.shapes[k])
        m, d = cuts[k]
        if m is not None:
            want[m] //= grid.model.size
        if d is not None:
            want[d] //= grid.data.size
        if list(t.shape) != want:
            bad.append((k, list(t.shape), want))
    check(not bad, f"tp_train_path {arch} rank {grid.rank}: leaves not cut "
          f"as train_param_cuts says: {bad[:4]}")
    out["rank_params"] = sum(t.numel() for _, t in topt.leaves(params))
    out["model_cut_leaves"] = sum(1 for c in cuts.values()
                                  if c[0] is not None)
    out["setup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grid.world.barrier()
    runtime.collective_stats(reset=True)
    log = moe.drop_log() if cfg.moe else None
    ops.reset_launch_counts()
    steps, prof, wall = [], None, 0.0
    for i in range(TP_TRAIN_STEPS):
        if i == TP_TRAIN_STEPS - 1:
            # the device's kernels only: the host ops' events of a plain
            # scan backward took 15 s to summarize
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        before = ops.launch_counts()
        c0 = runtime.COLLECTIVES["seconds"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if prof is not None:
            wall += dt
        after = ops.launch_counts()
        steps.append({"ms": dt * 1e3, "loss": loss,
                      "grad_norm": float(m["grad_norm"]),
                      "aux": float(m["aux"]),
                      "collective_s": runtime.COLLECTIVES["seconds"] - c0,
                      "launches": {k: after[k] - before[k] for k in after},
                      "profiled": prof is not None})
    t1 = time.perf_counter()
    prof.__exit__(None, None, None)
    out["launches"] = ops.launch_counts()
    if log is not None:
        out["drops"] = [int(e["dropped"]) for e in log]
        moe.drop_log(False)
    out["collectives"] = runtime.collective_stats()
    out["steps"] = steps
    t2 = time.perf_counter()
    s = profile_summary(prof, wall, 1, f"tp_train_path {arch}")
    out["profile_s"] = {"exit": t2 - t1, "summary": time.perf_counter() - t2}
    out["profile"] = {k: s[k] for k in (
        "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
        "top_kernels")}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    if grid.rank == 0:
        emit({"tp_train_rank0": arch, "seconds": out["seconds"],
              "setup_s": out["setup_s"], "profile_s": out["profile_s"],
              "steps_ms": [s["ms"] for s in steps],
              "peak_memory_bytes": out["peak_memory_bytes"]})
    del params, state, step, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train_rank(grid, t_spawn):
    """One rank of tp_train_path: every config of TP_TRAIN in turn."""
    dev = grid.device
    exact_matmuls()
    res = {"rank": grid.rank, "start_s": time.time() - t_spawn}
    t = time.perf_counter()
    for arch in TP_TRAIN:
        res[arch] = tp_train_family(grid, dev, arch)
    res["wall_s"] = time.perf_counter() - t
    return res


def tp_train_one_device(dev, arch, n=2):
    """The one-device train step of the same config on the same params and
    batches: its first ``n`` steps' losses, gradient norms and ``aux``."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = tp_train_cfg(arch)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 70), device=dev)
    state = topt.init_state(params, tp_train_opt())
    step = tstep.make_train_step(cfg, tp_train_opt())
    hist = []
    for b in tp_train_batches(cfg, TP_TRAIN[arch], n):
        params, state, m = step(params, state, b)
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return hist


def tp_train_rounding_probe(dev, arch):
    """The one-device step-1 gradient norm of ``arch`` (its TP_TRAIN depth,
    params and first batch), as the step computes it and with every
    projection of ``layers.linear`` taken as a float32 GEMM of the
    compute-dtype values rounded once to the compute dtype (the same
    function, other roundings): (norm, perturbed norm)."""
    from repro_torch.models import layers
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = tp_train_cfg(arch)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 70), device=dev)
    batch = tstep.batch_to(tp_train_batches(cfg, TP_TRAIN[arch], 1)[0], dev)
    flat = [t.requires_grad_(True) for _, t in topt.leaves(params)]
    plain = layers.linear

    def f32_linear(x, w, reciprocal_scale=False):
        return (x.float() @ w.to(x.dtype).float()).to(x.dtype)

    norms = []
    for fn in (plain, f32_linear):
        layers.linear = fn
        try:
            grads = torch.autograd.grad(api.loss_fn(params, batch, cfg)[0],
                                        flat)
        finally:
            layers.linear = plain
        norms.append(float(torch.sqrt(sum((g.float() ** 2).sum()
                                          for g in grads))))
        del grads
    del params, flat
    gc.collect()
    torch.cuda.empty_cache()
    return norms


def phase_tp_train_path(dev, smi_line):
    """tp_train_path: each config of TP_TRAIN trained at full width by a
    (1, 2) grid of two gloo ranks on the one card (one ``runtime.spawn``,
    as ``launch.train --tp 2`` starts them), then its one-device step in
    this process.  Per config: every rank's losses the same; step 1's loss
    within a relative 1e-3 of ``api.loss_fn`` on the whole params in one
    process; step 1's gradient norm and step 2's loss within
    ``DIST_ONE_DEVICE_RTOL`` of the one-device step's; the flash and scan
    launches a rank a step exactly as pinned and no W4A8 or paged launch;
    a MoE config's ``aux`` at step 1 within the same bound of the one-device
    value and its drop log the same on both ranks.  Reported per config:
    ms per step (step 2, the first after warm-up), per rank the seconds
    inside collectives in that step, the busy share over the profiled
    step 3, and the peak memory."""
    from repro_torch.distributed import runtime
    t0 = time.perf_counter()
    backend, devices = runtime.plan(TP_TRAIN_SHAPE, dev)
    ranks = runtime.spawn(tp_train_rank, TP_TRAIN_SHAPE, (time.time(),),
                          backend=backend, devices=devices, timeout=600)
    spawn_s = time.perf_counter() - t0
    per_cfg, one_device_s = {}, 0.0
    held = []                 # every check, raised after the phase's line

    def hold(cond, msg):
        held.append((bool(cond), msg))

    launches = {k: 0 for k in ops.KERNELS}
    for arch, spec in TP_TRAIN.items():
        t1 = time.perf_counter()
        one = tp_train_one_device(dev, arch)
        one_device_s += time.perf_counter() - t1
        runs = [r[arch] for r in ranks]
        a = runs[0]
        losses = [s["loss"] for s in a["steps"]]
        norms = [s["grad_norm"] for s in a["steps"]]
        rel = abs(losses[0] - a["one_process_loss"]) / abs(
            a["one_process_loss"])
        rel_loss2 = abs(losses[1] - one[1]["loss"]) / abs(one[1]["loss"])
        rel_norm1 = abs(norms[0] - one[0]["grad_norm"]) / abs(
            one[0]["grad_norm"])
        want = {"w4a8_matmul": 0, "paged_decode_attention": 0,
                "flash_attention": spec["flash"], "rwkv6_scan": spec["scan"]}
        for r in runs:
            hold(all(s["launches"] == want for s in r["steps"]),
                 f"tp_train_path {arch}: launches a rank a step "
                 f"{[s['launches'] for s in r['steps']]} != {want}")
            hold([s["loss"] for s in r["steps"]] == losses,
                 f"tp_train_path {arch}: the ranks' losses differ")
        for k in launches:
            launches[k] += a["launches"][k]
        hold(rel <= 1e-3, f"tp_train_path {arch}: step 1's loss "
             f"{losses[0]} vs one process's {a['one_process_loss']} "
             f"(relative {rel})")
        grad_rtol = spec.get("grad_rtol", DIST_ONE_DEVICE_RTOL)
        hold(rel_norm1 <= grad_rtol,
             f"tp_train_path {arch}: step 1's gradient norm {norms[0]} vs "
             f"the one-device step's {one[0]['grad_norm']} ({rel_norm1})")
        hold(rel_loss2 <= DIST_ONE_DEVICE_RTOL,
             f"tp_train_path {arch}: step 2's loss {losses[1]} vs the "
             f"one-device step's {one[1]['loss']} ({rel_loss2})")
        hold(all(np.isfinite(losses)), f"tp_train_path {arch}: {losses}")
        row = {"config": arch, "layers": spec["layers"],
               "batch": spec["batch"], "seq": spec["seq"],
               "losses": losses, "grad_norms": norms,
               "one_process_loss": a["one_process_loss"],
               "step1_loss_rel_diff": rel,
               "one_device": one, "step2_loss_rel_diff": rel_loss2,
               "step1_grad_norm_rel_diff": rel_norm1,
               "ms_per_step": max(r["steps"][1]["ms"] for r in runs),
               "steps_ms": [[s["ms"] for s in r["steps"]] for r in runs],
               "collective_s_per_step": [r["steps"][1]["collective_s"]
                                         for r in runs],
               "collective_calls_per_step": [
                   r["collectives"]["calls"] / TP_TRAIN_STEPS for r in runs],
               "busy_share": [r["profile"]["device_busy_share"]
                              for r in runs],
               "profile": [r["profile"] for r in runs],
               "peak_memory_bytes": [r["peak_memory_bytes"] for r in runs],
               "rank_params": [r["rank_params"] for r in runs],
               "model_cut_leaves": a["model_cut_leaves"],
               "setup_s": [r["setup_s"] for r in runs],
               "seconds": [r["seconds"] for r in runs],
               "launches_per_rank_step": want,
               "step1_grad_norm_rtol": grad_rtol}
        if arch in TP_TRAIN_PROBE:
            t1 = time.perf_counter()
            base, f32 = tp_train_rounding_probe(dev, arch)
            one_device_s += time.perf_counter() - t1
            row["one_device_rounding_probe"] = {
                "grad_norm": base, "grad_norm_f32_projections": f32,
                "rel": abs(f32 - base) / abs(base)}
        if get_config(arch).moe:
            aux = [s["aux"] for s in a["steps"]]
            rel_aux = abs(aux[0] - one[0]["aux"]) / abs(one[0]["aux"])
            hold(all([s["aux"] for s in r["steps"]] == aux for r in runs)
                 and rel_aux <= DIST_ONE_DEVICE_RTOL,
                 f"tp_train_path {arch}: aux {aux} vs the one-device "
                 f"{one[0]['aux']} ({rel_aux})")
            hold(all(r["drops"] == a["drops"] for r in runs),
                 f"tp_train_path {arch}: the ranks' drop logs differ")
            row.update(aux=aux, step1_aux_rel_diff=rel_aux,
                       drops_per_call=a["drops"],
                       ranks_drop_logs_equal=True)
        per_cfg[arch] = row
    seconds = time.perf_counter() - t0
    info = {"phase": "tp_train_path", "grid": list(TP_TRAIN_SHAPE),
            "backend": backend, "devices": devices, "steps": TP_TRAIN_STEPS,
            "configs": per_cfg, "launches_per_rank": launches,
            "spawn_s": spawn_s, "one_device_s": one_device_s,
            "rank_wall_s": [r["wall_s"] for r in ranks],
            "seconds": seconds, "card": smi_line}
    emit(info)
    for cond, msg in held:
        check(cond, msg)
    check(seconds <= TP_TRAIN_SECONDS * DIST_SLACK,
          f"tp_train_path took {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


def phase_times_tp_train(dev, info):
    """The kernels at a tp_train_path rank's shapes, timed here by one
    process on the whole card (the ranks shared it): the flash kernel over
    each shape's launches of one rank step (TP_TRAIN_FLASH), and the scan
    over rwkv6-7b's two (B 4, H 32, T 256, D 64)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    detail, rows = [], {}
    for key, arch, n, label, shape, opts in TP_TRAIN_FLASH:
        rows[key] = flash_case_times(gen, dev, n, label, shape, opts,
                                     n * TP_TRAIN_STEPS, detail,
                                     key + "_library")
    bf = torch.bfloat16
    n = TP_TRAIN["rwkv6-7b"]["scan"]
    launches = [rwkv_inputs(gen, dev, *TP_TRAIN_SCAN, bf, "model")
                for _ in range(n)]

    def fwd(fn):
        return lambda: [fn(*a) for a in launches]

    bound_ms, bound_by = rwkv_bound(*TP_TRAIN_SCAN, 2, launches=n)
    rows["scan_tp_train_rank"] = {
        "unit": f"one rwkv6-7b tp-train rank step: {n} launches, B 4, H 32, "
                "T 256, D 64, bf16, CUDA-graph replay; plain timed eagerly",
        "launches": info["launches"]["rwkv6_scan"],
        "ms": graph_time_ms(fwd(ops.rwkv6), iters=20),
        "eager_ms": cuda_time_ms(fwd(ops.rwkv6), iters=3),
        "plain_ms": cuda_time_ms(fwd(ref.rwkv6_scan), iters=1, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": "none: no single PyTorch call computes the WKV "
                        "recurrence"}
    emit({"phase": "times", "path": "tp_train_path", **rows,
          "detail": detail})
    return rows


# ------------------------------------------------------------- dryrun_path
DRYRUN_CAL = (
    ("a", "stablelm-1.6b", None, ("train", 512, 8), "baseline"),
    ("b", "stablelm-1.6b", None, ("prefill", 4096, 1), "baseline"),
    ("c", "stablelm-1.6b", None, ("decode", 4096, 8), "opt"),
    ("d", "rwkv6-7b", 2, ("prefill", 512, 1), "baseline"),
)
DRYRUN_FULL = (("granite-8b", "train_4k", "baseline"),
               ("gemma2-27b", "prefill_32k", "baseline"),
               ("qwen3-moe-235b-a22b", "decode_32k", "opt"))
# the kernels' checks at the shapes that (b) and (d) launch them at
# ((a)'s flash shape is TRAIN_FLASH_CASE, (c)'s W4A8 ones W4A8_SHAPES and
# W4A8_DRYRUN)
DRYRUN_FLASH_CASE = ("stablelm-1.6b prefill", (1, 32, 32, 4096, 4096, 64),
                     dict(causal=True))
DRYRUN_SCAN_CASE = ("rwkv6-7b prefill, B 1", (1, 64, 512, 64),
                    torch.bfloat16, "model")
# the temporaries (the card's peak over the step minus what was allocated
# just before it) against the trace's: within 4e-6 in every run so far;
# the raw peak against the prediction (arguments + temporaries) is held
# only in a run of this phase alone (`--only dryrun`), where the process
# holds no more than cuBLAS's 64 MiB of workspaces besides the step's
# arguments (0.16-1.2 % of these peaks); at the end of the whole script
# it holds 840 MB from earlier phases, and the raw peak is reported
DRYRUN_PEAK_RTOL = 0.02
DRYRUN_TEMP_RTOL = 1e-4
DRYRUN_TIMED = 3
SOFTCAP_PROBE = 2 ** 24        # float32 logits across their range


def dryrun_cal_config(arch, layers, shape, variant):
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if shape.kind == "train":
        # train_path's remat: the training CLI forces "none"
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, remat="none"))
    cfg = dryrun.apply_variant(cfg, shape, variant)
    return dryrun.adapt_parallel(cfg, shape, dryrun.grid_shape((1, 1)))


def dryrun_calibrate(dev, run):
    """One calibration run: the meta trace at grid (1, 1), then the same
    step built on the card from seeded weights: launches and argument
    bytes against the trace's, the predicted peak against
    ``max_memory_allocated``, the median time against the roofline."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa
    name, arch, layers, (kind, T, B), variant = run
    shape = ShapeConfig(f"cal_{name}", T, B, kind)
    cfg = dryrun_cal_config(arch, layers, shape, variant)
    t0 = time.perf_counter()
    rec = dryrun.trace(cfg, shape, (1, 1))
    t_trace = time.perf_counter() - t0
    roof = dryrun.roofline(rec["totals"], 1, cfg, shape)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(SEED + 40)
    step = dryrun.build_step(cfg, shape, oa.stand_in_grid((1, 1), dev), dev,
                             gen)
    out = step.run()                          # warm-up
    torch.cuda.synchronize()
    ms, peaks, bases, launches = [], [], [], []
    for _ in range(DRYRUN_TIMED):
        out = None
        gc.collect()
        torch.cuda.synchronize()
        bases.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step.run()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated())
        launches.append(ops.launch_counts())
    out = None
    want = {k: int(rec["kernel_calls"].get(k, 0)) for k in ops.KERNELS}
    predicted = rec["memory"]["argument_size_in_bytes"] + \
        rec["memory"]["temp_size_in_bytes"]
    med = float(np.median(ms))
    info = {
        "run": name, "config": cfg.name, "layers": cfg.num_layers,
        "kind": kind, "B": B, "T": T, "variant": variant,
        "trace_s": rec["trace_s"], "trace_wall_s": t_trace,
        "kernel_calls_meta": want, "launches_card": launches,
        "argument_bytes_meta": rec["memory"]["argument_size_in_bytes"],
        "argument_bytes_card": step.argument_bytes,
        "temp_bytes_meta": rec["memory"]["temp_size_in_bytes"],
        "predicted_peak_bytes": predicted,
        "card_peak_bytes": peaks, "card_allocated_before_bytes": bases,
        "peak_rel_err": [(p - predicted) / p for p in peaks],
        "temp_rel_err": [(p - b - rec["memory"]["temp_size_in_bytes"])
                         / max(p - b, 1) for p, b in zip(peaks, bases)],
        "host_reads": rec["host_reads"],
        "ms": ms, "median_ms": med,
        "t_bound_ms": roof.t_bound * 1e3, "t_ideal_ms": roof.t_ideal * 1e3,
        "bottleneck": roof.bottleneck,
        "t_compute_ms": roof.t_compute * 1e3,
        "t_memory_ms": roof.t_memory * 1e3,
        "below_bound": med < roof.t_bound * 1e3 / 1.05,
        "flops_meta": rec["totals"]["flops_per_chip"],
        "bytes_meta": rec["totals"]["mem_bytes_per_chip"],
        "top_bytes_by_kind": dict(sorted(
            rec["totals"]["mem_by_kind"].items(), key=lambda kv: -kv[1])[:6])}
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return info, launches


def dryrun_softcap_probe(dev):
    """gemma2's softcap division on the card and on the CPU over float32
    logits spread across their range (every 2^32 / SOFTCAP_PROBE-th bit
    pattern, the non-finite ones dropped): the plain ``logits / cap``
    (reported) and ``ref._soft_cap`` (checked bit for bit)."""
    cap = get_config("gemma2-27b").softcap
    bits = torch.arange(SOFTCAP_PROBE, dtype=torch.int64) * (
        2 ** 32 // SOFTCAP_PROBE) - 2 ** 31
    x = bits.to(torch.int32).view(torch.float32)
    x = x[torch.isfinite(x)]
    xd = x.to(dev)
    div = int(((xd / cap).cpu().view(torch.int32)
               != (x / cap).view(torch.int32)).sum())
    capped = int(((ref._soft_cap(xd, cap).cpu().view(torch.int32))
                  != ref._soft_cap(x, cap).view(torch.int32)).sum())
    return {"logits": int(x.numel()), "cap": cap,
            "div_by_python_number_differs": div,
            "soft_cap_differs": capped}


def dryrun_full_traces():
    """DRYRUN_FULL's cells, traced one after another on the host (nothing
    on the card): each cell's report row, its trace's seconds and what it
    predicts."""
    from repro_torch.launch import dryrun, report
    full = []
    for arch, shape, variant in DRYRUN_FULL:
        t0 = time.perf_counter()
        res = dryrun.lower_cell(arch, shape, variant)
        check(res["status"] == "ok",
              f"dryrun_path: the trace of {arch} {shape} {variant}: {res}")
        full.append({"cell": f"{arch} {shape} {variant}",
                     "row": report.fmt_row(res), "trace_s": res["trace_s"],
                     "build_s": res["build_s"],
                     "wall_s": time.perf_counter() - t0,
                     "memory": res["memory"],
                     "kernel_calls": res["kernel_calls"]})
    return full


def phase_dryrun_path(dev, smi_line, alone=False):
    """dryrun_path: DRYRUN_CAL's steps traced on meta and run on the card
    (launches and argument bytes exact, the temporaries within
    DRYRUN_TEMP_RTOL, the raw peak within DRYRUN_PEAK_RTOL when ``alone``),
    the softcap probe, and DRYRUN_FULL's traces."""
    t_phase = time.perf_counter()
    runs, counts = [], {k: 0 for k in ops.KERNELS}
    for run in DRYRUN_CAL:
        info, launches = dryrun_calibrate(dev, run)
        runs.append(info)
        for c in launches:
            for k, v in c.items():
                counts[k] += v
    probe = dryrun_softcap_probe(dev)
    t_full = time.perf_counter()
    full = dryrun_full_traces()
    info = {"phase": "dryrun_path", "calibration": runs, "full": full,
            "full_traces_s": time.perf_counter() - t_full,
            "raw_peak_checked": alone,
            "softcap": probe, "launches": counts,
            "seconds": time.perf_counter() - t_phase, "card": smi_line}
    emit(info)
    for r in runs:
        for c in r["launches_card"]:
            check(c == r["kernel_calls_meta"],
                  f"dryrun_path ({r['run']}) launches {c} != the trace's "
                  f"{r['kernel_calls_meta']}")
        check(r["argument_bytes_card"] == r["argument_bytes_meta"],
              f"dryrun_path ({r['run']}) argument bytes "
              f"{r['argument_bytes_card']} != the trace's "
              f"{r['argument_bytes_meta']}")
        check(all(abs(e) <= DRYRUN_TEMP_RTOL for e in r["temp_rel_err"]),
              f"dryrun_path ({r['run']}) temporaries {r['temp_rel_err']} "
              f"from the trace's {r['temp_bytes_meta']}: outside "
              f"{DRYRUN_TEMP_RTOL}")
        check(not alone or all(abs(e) <= DRYRUN_PEAK_RTOL
                               for e in r["peak_rel_err"]),
              f"dryrun_path ({r['run']}) peak {r['card_peak_bytes']} vs "
              f"predicted {r['predicted_peak_bytes']}: outside "
              f"{DRYRUN_PEAK_RTOL}")
    check(probe["soft_cap_differs"] == 0,
          f"ref._soft_cap differs between the card and the CPU: {probe}")
    return info


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # flex_attention's compiled kernels cache inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build.BUILD_DIR / sub))
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    smi = dev_info["nvidia_smi"]
    phase_build()
    if argv == ["--only", "moe"]:
        # a quicker call for work on the MoE path alone: no kernels line
        # and no ok line, so it never stands for the whole script
        run_moe(dev, smi)
        emit({"subset": "moe", "done": True})
        return 0
    if argv == ["--only", "tp"]:
        # the tensor-parallel phase alone (its tp 1 tokens served here),
        # with the kernels' checks at its ranks' shapes
        phase_w4a8(dev, shapes=W4A8_TP)
        phase_paged(dev, cases=PAGED_TP_CASES)
        phase_flash(dev, cases=FLASH_TP_CASES)
        phase_times_tp(dev, phase_tp_path(dev, smi))
        emit({"subset": "tp", "done": True})
        return 0
    if argv == ["--only", "xattn"]:
        # the same for the cross-attention families, with the flash
        # kernel's checks at their shapes
        phase_flash(dev, cases=XATTN_FLASH_CASES)
        run_xattn(dev, smi)
        emit({"subset": "xattn", "done": True})
        return 0
    if argv == ["--only", "dryrun"]:
        # the dry run's phase alone, then the kernels' checks at its shapes
        phase_dryrun_path(dev, smi, alone=True)
        phase_w4a8(dev, shapes=W4A8_DRYRUN)
        phase_flash(dev, cases=[TRAIN_FLASH_CASE, DRYRUN_FLASH_CASE])
        phase_rwkv(dev, cases=[DRYRUN_SCAN_CASE])
        emit({"subset": "dryrun", "done": True})
        return 0
    if argv == ["--only", "train"]:
        # the training phases alone, with the flash kernel's check at the
        # train step's shape
        phase_flash(dev, cases=[TRAIN_FLASH_CASE, DIST_FLASH_CASE]
                    + tp_train_flash_cases())
        phase_rwkv(dev, cases=[TP_TRAIN_SCAN_CASE])
        phase_train_kernels(dev)
        phase_tp_train_grads(dev)
        phase_train_path(dev, smi)
        phase_times_dist(dev, phase_dist_train_path(dev, smi))
        phase_times_tp_train(dev, phase_tp_train_path(dev, smi))
        emit({"subset": "train", "done": True})
        return 0
    check(not argv, f"unknown arguments {argv} (only `--only moe`, "
          "`--only xattn`, `--only tp`, `--only train` or `--only dryrun`)")
    phase_sanitizer()
    errs = {"w4a8_matmul": phase_w4a8(dev),
            "paged_decode_attention": phase_paged(dev),
            "flash_attention": phase_flash(dev),
            "rwkv6_scan": phase_rwkv(dev)}
    phase_reference(dev)
    phase_reference_serve(dev)
    phase_reference_rwkv(dev)
    eng, main_info = phase_main_path(dev, smi)
    phase_profile(eng, dev, "main_path")
    kernels = phase_times(eng, dev, main_info["launches"])
    split_info = phase_features_splitbrain(eng, dev, smi)
    chaos_a = phase_chaos_splitbrain(eng, main_info, smi)
    del eng                          # release tinyllama before llama2-7b
    gc.collect()
    torch.cuda.empty_cache()
    examples_info = phase_examples_path(dev, smi)
    tp_info = phase_tp_path(dev, smi, main_info["_tokens"][:8])
    tp_rows = phase_times_tp(dev, tp_info)
    eng, serve_info = phase_serve_path(dev, smi)
    phase_profile(eng, dev, "serve_path")
    fwd_serve = phase_lm_forward(eng, dev, "serve_path")
    flash, paged_llama2 = phase_times_serve(dev, serve_info)
    kernels.append(flash)
    feng, feat_info = phase_features_path(eng, dev, smi)
    feat_prof = phase_profile(feng, dev, "features_path int8 pool")
    del feng
    chaos_bcd, chaos_serve_launches = phase_chaos_serve(eng, serve_info, smi)
    chaos_launches = {k: chaos_a["launches"][k] + chaos_serve_launches[k]
                      for k in chaos_serve_launches}
    emit({"phase": "chaos_path", "runs": [chaos_a] + chaos_bcd,
          "launches": chaos_launches, "card": smi})
    paged_kv = phase_times_kv(dev, serve_info, feat_info)
    del eng                          # release llama2-7b before rwkv6-7b
    gc.collect()
    torch.cuda.empty_cache()
    eng, rwkv_info = phase_rwkv_path(dev, smi)
    phase_profile(eng, dev, "rwkv_path")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase_times_rwkv(dev, rwkv_info))
    phase_reference_hymba(dev)
    eng, hymba_info = phase_hymba_path(dev, smi)
    hymba_prof = phase_profile(eng, dev, "hymba_path")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    flash_h, paged_h = phase_times_hymba(dev, hymba_info)
    eng, gemma2_info = phase_gemma2_path(dev, smi)   # after the others: 69 GB
    prof = phase_profile(eng, dev, "gemma2_path", slots=GEMMA2_SLOTS)
    fwd_gemma2 = phase_lm_forward(eng, dev, "gemma2_path")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    flash_g, paged_g = phase_times_gemma2(dev, gemma2_info)
    moe_launches, moe_rows, fwd_moe = run_moe(dev, smi)
    vision_launches, encdec_launches, xattn_rows = run_xattn(dev, smi)
    train_row = phase_train_kernels(dev)
    phase_tp_train_grads(dev)
    train_info = phase_train_path(dev, smi)
    dist_info = phase_dist_train_path(dev, smi)
    dist_row = phase_times_dist(dev, dist_info)
    tp_train_info = phase_tp_train_path(dev, smi)
    tp_train_rows = phase_times_tp_train(dev, tp_train_info)
    dryrun_info = phase_dryrun_path(dev, smi)
    emit({"gemma2_path_summary": {
        key: gemma2_info[key] for key in (
            "decode_steps_per_s", "decode_tokens_per_s",
            "prefill_tokens_per_s", "tokens_per_s_wall",
            "setup_peak_memory_bytes", "peak_memory_bytes")},
        "device_busy_share": prof["device_busy_share"],
        "card": smi})
    emit({"hymba_path_summary": {
        key: hymba_info[key] for key in (
            "decode_steps_per_s", "decode_tokens_per_s",
            "prefill_tokens_per_s", "tokens_per_s_wall",
            "setup_peak_memory_bytes", "peak_memory_bytes")},
        "forward_tokens_per_s": hymba_info["forward"]["tokens_per_s"],
        "profile": {key: hymba_prof[key] for key in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "host_ops_per_step")},
        "card": smi})
    emit({"chaos_path_summary": [
        {key: run[key] for key in ("run", "decode_steps_per_s",
                                   "clean_decode_steps_per_s", "recovery_s",
                                   "identical_to_fault_free")
         if key in run} for run in [chaos_a] + chaos_bcd[:1]]
        + [{"run": chaos_bcd[2]["run"],
            "trip_after_stall_s": chaos_bcd[2]["trip_after_stall_s"],
            "recoveries": chaos_bcd[2]["stats"]["recoveries"]}],
        "card": smi})
    emit({"features_path_summary": {
        run: {key: info[key] for key in (
            "decode_steps_per_s", "decode_tokens_per_s",
            "prefill_tokens_per_s", "tokens_per_s_wall",
            "peak_memory_bytes")}
        for run, info in feat_info["runs"].items()},
        "quantized": feat_info["quantized"],
        "int8_pool_profile": {key: feat_prof[key] for key in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "host_ops_per_step")},
        "card": smi})
    for k in kernels:
        k["max_abs_err"] = errs[k["name"]]
        k["launches_by_path"] = {
            "main_path": main_info["launches"][k["name"]],
            "serve_path": serve_info["launches"][k["name"]],
            "rwkv_path": rwkv_info["launches"][k["name"]],
            "gemma2_path": gemma2_info["launches"][k["name"]],
            "features_path": sum(r["launches"][k["name"]]
                                 for r in feat_info["runs"].values()),
            "features_splitbrain": split_info["launches"][k["name"]],
            "chaos_path": chaos_launches[k["name"]],
            "examples_path": examples_info["launches"][k["name"]],
            "hymba_path": hymba_info["launches"][k["name"]],
            "moe_path": moe_launches[k["name"]],
            "vision_path": vision_launches[k["name"]],
            "encdec_path": encdec_launches[k["name"]],
            "lm_forward": (fwd_serve[k["name"]] + fwd_gemma2[k["name"]]
                           + fwd_moe[k["name"]]),
            "tp_path": tp_info["launches"][k["name"]],
            "train_path": train_info["launches"][k["name"]],
            "dist_train_path": dist_info["launches"][k["name"]],
            "tp_train_path": tp_train_info["launches"][k["name"]],
            "dryrun_path": dryrun_info["launches"][k["name"]]}
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    kernels[1]["llama2_decode"] = paged_llama2
    kernels[1]["llama2_decode_int8"] = paged_kv["int8"]
    kernels[1]["llama2_decode_fp8"] = paged_kv["fp8"]
    kernels[1]["gemma2_decode"] = paged_g
    kernels[2]["gemma2_prefill"] = flash_g
    kernels[1]["hymba_decode"] = paged_h
    kernels[2]["hymba_forward"] = flash_h
    kernels[1]["phi_moe_decode"] = moe_rows["a"][1]
    kernels[2]["phi_moe_prefill"] = moe_rows["a"][0]
    kernels[1]["qwen_moe_decode"] = moe_rows["b"][1]
    kernels[2]["qwen_moe_prefill"] = moe_rows["b"][0]
    for key, row in xattn_rows.items():
        kernels[2][key] = row
    kernels[2]["train_step"] = {**train_row,
                                "launches": train_info["launches"][
                                    "flash_attention"]}
    kernels[2]["dist_train_rank_step"] = dist_row
    for key, row in tp_rows.items():
        kernels[1 if key.startswith("paged") else 2][key] = row
    for key, row in tp_train_rows.items():
        kernels[3 if key.startswith("scan") else 2][key] = row
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_info["name"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
