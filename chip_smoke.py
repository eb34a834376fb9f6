#!/usr/bin/env python3
"""Drive the PyTorch port's annotation-eval, MCQ-eval, LoRA-training and
stage-(a) paths once on one CUDA GPU, with the llama, qwen2 and opt
decoder families, then its command line (beam search, the static draft)
and its checkpoint loaders.

    python3 chip_smoke.py

Phases, each printed on its own lines; the first failure exits non-zero
and prints no result:
  1. device: needs torch.cuda.is_available(); prints `nvidia-smi`'s card
     name and power limit;
  2. build: compiles each opus_pllm_tpu_torch/csrc/*.cu with its own nvcc
     (sm_90a), all started together, and prints the build times and the
     compiler's register report;
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs. Passes when
     max|kernel - plain_fp32| <= 2 * max|plain_bf16 - plain_fp32| + ATOL,
     where plain_fp32 runs the plain version on the same inputs in fp32,
     plain_bf16 in bf16 (its error is the rounding the bf16 formats force),
     and ATOL = 4e-3 (half a bf16 ulp at magnitude 1-2) covers the kernels'
     other summation order. Prints kernel (and its TFLOP/s), plain and
     library device times (the host held behind a queued device sleep),
     the kernel's time per call as the host issues it, and the bound: the
     larger of the bytes the function must move over 3.35 TB/s and its
     bf16 tensor-core operations over 989 TFLOP/s (H100 SXM data sheet),
     counting only the work this run's data needs (valid cache slots,
     mask-true query-key pairs).
     Shapes:
       - the four fused-encoder kernels at the annotate path's shapes (B=8,
         S in {128, 512}, E=1280, H=20, F=5120, bf16, padded key rows; the
         bound of encoder_attention counts the valid keys only, whose
         64-key tiles the kernel loads). Library for encoder_attention:
         scaled_dot_product_attention with the same key mask; printed
         beside ln_qkv_rope, out_proj and ffn (not in the JSON line): the
         bf16 cuBLAS products they contain at the same (M, K, N), marked *;
       - int4_matmul at M = 8 for each distinct (K, N) of a Llama-3-8B
         decode step: 4096->4096, 4096->1024, 4096->14336, 14336->4096,
         4096->128256 (random weights quantized by quant4.quantize_grouped),
         with the kernel's earlier design (kept for N % 4 != 0) beside it;
       - decode_attention_int8 / _int4 at B=8, Hq=32, Hkv=8, D=128 over a
         391-slot cache (the annotate decode capacity), at B=32 over 2048
         slots (lengths uniform over cap/2..cap), and with the static
         decode's mask at B=8 over 391 slots (left padding, then an
         unwritten tail: the kernel skips the 16-slot slabs false
         everywhere, and the bound counts the valid slots only);
       - flash_attention at the serving prefill (16 rows of bucket 320, the
         engine's admission mask), the static prefill (8 x 327 queries over
         a 391-slot left-padded cache, whose padding rows have no valid key:
         the kernel gives them out 0, as the plain version does), causal
         B=1, S=2048, the training shape (B=16, L=519, the training mask:
         64 launches a train step run there) and the text encoder's prefill
         (B=8, S=1792, causal with right-padded captions, whose padding
         rows attend the valid keys); Hq=32, Hkv=8, D=128; then the static
         prefill with Qwen2.5-7B's heads (Hq=28, Hkv=4: G=7) and
         Galactica-6.7B's (32 / 32: G=1); then the serving options'
         shapes (masks from their own generator): the verify pass (B=17,
         Sq=4 over 1024 slots, per-row lengths 64-960: cols <= length +
         j), a chunk (4 rows of 256 queries at offsets 0 / 256 / 512 / 768
         of 1024 keys) and a prefix merge (8 rows of 128 queries over 64
         prefix + 128 suffix keys); every mask gives each query row a
         valid key. The
         kernel skips the 64-key tiles whose mask is false everywhere (the
         bound counts mask-true pairs only). Library: torch's
         scaled_dot_product_attention with the same mask (K/V heads
         repeated beforehand);
       - int8_matmul at M = 5120 (serving prefill) and 2616 (static
         prefill) for the four (K, N) of a Llama-3-8B layer. Library: the
         bf16 cuBLAS product on W dequantized beforehand (the dequantize
         not timed, so not the same function); the port's own dequantize
         route (`quant.dequant_matmul`), which is, beside it (route_ms),
         and the kernel's earlier design, kept for unaligned N;
       - flash_attention_bwd_dq and _dkv (the saved out and lse of the
         forward kernel as inputs, dk and dv stacked into one output) at
         the training shape (B=16, L=519, right-padded valid lengths, the
         causal_mask of opus.forward) and causal B=1, S=2048; Hq=32,
         Hkv=8, D=128. Gradients are larger than 1, so ATOL is scaled by
         max(1, max|plain_fp32|). Library: the backward of
         scaled_dot_product_attention with the same mask, timed as
         backward only (it computes dq, dk and dv; so does the plain
         version, in both rows);
       - int4_matmul_v1 at M = 8304 (a train-lora batch, 16 x 519) for the
         five (K, N) of Llama-3-8B. Library: cuBLAS bf16 on W dequantized
         beforehand; the dequantize route (`quant4.dequant_matmul`) beside
         it (route_ms), and the earlier design, kept for unaligned N;
     the JSON line keeps, per kernel, the largest error over its shapes and
     the times of one shape: S=512 (encoder), 4096->4096 (int4), cap 391
     (decode attention), the serving prefill (flash), M=5120 4096->14336
     (int8), the training shape (flash backward) and 4096->14336 (v1);
  4. slice: OpusConfig() at full width (ESM2-650M and Llama-3-8B in bf16,
     CSTP 1280->5120 and the mlp2x_gelu switch 5120->8x4096 in fp32, random
     weights drawn on the card from a seeded torch.Generator) answers 16
     synthetic keywords-task requests through
     evals.runner.run_annotation_eval (batch 8, T=0.1, top_p=0.7, 64 new
     tokens, ByteTokenizer). Checks the launch counts exactly: every
     encoder kernel 33 x batches, flash_attention 32 x batches (each
     prefill layer), no other kernel; that ESM2's pooled embedding through
     the kernels agrees with the plain layer composition on two proteins,
     and that the decoder's logits are finite; that the runner's metrics
     (Precision, Recall, F1 Score of the keywords task, against synthetic
     keyword answers) are finite and in [0, 1]; prints entries/s and
     decode tok/s;
  5. function metrics: the same params answer 8 synthetic function-task
     requests (one batch, 64 new tokens) through run_annotation_eval
     with bert_embed_fn = models.bert.make_embed_fn over a full-width
     BertConfig() (BioBERT-large: 24 x 1024, 16 heads, vocab 58996; fp32
     random weights drawn on the card from SEED) and a WordPieceTokenizer
     over a vocab made in the script (the special tokens, the printable
     ASCII characters and their ## forms; no file is read). Checks exact
     launch counts (each encoder kernel 33, flash_attention 32; the BERT's
     d = 64 fp32 attention takes the plain path, as in the JAX package);
     that ROUGE, BLEU, METEOR and BERTScore are finite and in [0, 1]; and
     that a text scored against itself gives BERTScore F1 = 1 within
     1e-5. Prints the BERT's GiB on the card and its seconds;
  6. mcq: the same params answer 16 synthetic 4-option questions
     (proteins of 60-500 residues, options "A) ..." to "D) ...", answers
     spread over A-D) written to a temporary *_mcq_*.json and read by
     evals.datasets.load_mcq_json, the ByteTokenizer's prompts in
     VICUNA_V3's ChatML, through evals.runner.run_mcq_eval (batch 8, the
     runner's default GenerationConfig: 50 new tokens, T=0.1, top_p=0.7),
     run_mcq_eval_scored (batch 8: one prefill scores the option letters)
     and run_mcq_eval_engine (16 slots, 4 steps a tick, bf16 cache), then
     metric_registry's perplexity over the 16 prompts through
     infer.scoring.make_logprob_fn (batch 8). Checks that every question
     is answered (16 results, OptionCounts summing to 16, Accuracy in
     [0, 1]), that the scored runner answers with option letters, exact
     launch counts (each encoder kernel 33 x splice batches;
     flash_attention 32 x batches for the static, scored and perplexity
     runs and 32 x the engine's prefills; every other kernel 0), that one
     batch's scored logits (`runner._mcq_next_logits`) through the kernels
     stay within the bound of phase 3 of the plain path in fp32 (ESM2 in
     fp32, the LLM with fp32 activations, embedding and norms), printed
     beside the plain path in bf16, and choose the fp32 path's letter in
     every row whose top two letter scores differ by more than twice that
     bound, and that every perplexity is finite and >= 1. Prints each
     runner's entries/s, the perplexity pass's seconds and the phase's
     wall;
  7. quantized slice: the same LLM quantized by quant4.quantize_decoder4
     (int4 v2 words, fp32 group scales; the bf16 projections are freed)
     answers the same 16 requests with an int4 KV cache, then one batch of
     8 with an int8 cache. Checks exact launch counts, each derived from
     the dispatch and the decode steps run (prefill projections have
     M = 8 x 327 > 64 rows and take the dequantize route, the prefill head
     and every decode projection and head the kernel):
       int4_matmul = batches + steps x (32 x 7 + 1),
       decode_attention_<cache> = steps x 32, the other one 0,
       flash_attention = 32 x batches, encoder kernels = 33 x batches;
     and that one decode step's logits through the kernels (impl="auto")
     stay within 2 * (plain bf16 error) + ATOL of the plain path run in
     fp32, next to the plain path in bf16 (impl="torch"). Prints entries/s,
     decode tok/s, ms per decode step and GiB on the card;
  8. serving slice: a bf16 Llama-3-8B drawn again from the seed, quantized
     to int8 by quant.quantize_decoder (the bf16 weights freed), answers 32
     synthetic requests through evals.runner.run_annotation_eval_engine
     (the continuous-batching engine: 16 slots, 4 steps a tick, T=0.1,
     top_p=0.7, 64 new tokens, bf16 cache), then 8 with an int8 cache.
     Checks exact launch counts from the engine's own counters: every
     admission group is one prefill of n x bucket >= 256 rows, so
       flash_attention = 32 x prefills, int8_matmul = 7 x 32 x prefills,
       decode_attention_<cache> = 32 x decode steps (int8 cache; none on
       the bf16 cache), encoder kernels = 33 x splice batches,
       int4_matmul = 0, and every kernel kept for unaligned N
       (int8_matmul_unaligned, int4_matmul_unaligned,
       int4_matmul_v1_unaligned) 0 in every phase;
     that every request is answered; and that one admission group's
     prefill logits (16 rows, bucket 320) through the kernels stay within
     the bound above of the plain path in fp32. Prints entries/s, tokens/s,
     TTFT p50/p99 (the engine's histogram bounds) and GiB on the card;
  9. engine options: phase 8's int8 LLM behind the serving engine at
     run_annotation_eval_engine's defaults (16 slots, 4 steps a tick; 64
     new tokens, ByteTokenizer prompts spliced by runner.splice_tails):
     (a) the LoRA bank: three random rank-16 adapters on the seven
     projections (B drawn non-zero, folded by lora.fold_scaling) and one
     spare row; 24 requests spread over the three adapters and the base
     (T=0.1, top_p=0.7), every one answered; a fourth adapter installed
     at runtime answers a request, and remove_adapter is refused while
     that request runs; one admission group's first-token logits (one
     row per adapter and the base) through the per-row gather and the
     kernels within phase 3's bound of each request through the 2-d
     lora_dense path in fp32; prints tok/s, the bank's and the peak GiB;
     (b) speculative ticks: draft_layers=8, spec_k=4, spec_adaptive=False,
     8 greedy and 8 sampled requests (T=0.1, top_p=0.7), every one
     answered; every row active at a tick's start consumes 1..4 tokens an
     iteration until it finishes, then 0; one verify pass (17 rows, K=4
     over the engine's cache, per-row lengths) through the kernels within
     the bound of the fp32 plain path; then, with layers 8-31 made the
     identity (a copy of their o_proj / down_proj with zeros in it), 8
     greedy requests, at least 2 tokens an iteration. Prints the mean
     tokens an iteration, tok/s and the plain engine's tok/s on the same
     requests, and how many greedy requests equal the plain ones;
     (c) the prefix cache: run_annotation_eval_engine(cache_prefix=True)
     on 16 keywords requests twice through one engine_cache (one engine;
     the reseeded engine repeats its sampled output bit for bit), then
     without the prefix; one group's first-token logits through the
     pinned prefix and the kernels within the bound of the whole prompt
     through the fp32 plain path; prints the prefill tokens saved and
     both TTFTs;
     (d) chunked prefill: chunk_prefill=256 over a 1024-slot cache, 4
     prompts of 700-960 tokens beside 12 keywords prompts, every one
     answered, then the same requests with one monolithic bucket; each
     long prompt's first-token logits through its chunks and the kernels
     within the bound of one monolithic prefill through the fp32 plain
     path; prints the short requests' TTFT (from their first streamed
     token) both ways.
     Exact launch counts: flash_attention = 32 x (prefills, chunks
     included), and with speculation 32 x (prefills + iterations) (each
     verify pass has Sq = 4; the one-token draft steps take the plain
     attention over the bf16 cache), + 32 for a pinned prefix;
     int8_matmul = 224 x (prefills and chunks of n x bucket >= 256 rows,
     and a pinned prefix of >= 256 tokens) (decode M = 17 and verify
     M = 68 take the dequantize route); encoder kernels 33 x splice
     batches; every other kernel 0. The LoRA products are plain bmm;
 10. server: serve.server.OpusServer over phase 4's ESM2, switch and a
     bf16 Llama-3-8B drawn again from the seed, with a CSTP whose text
     side takes 4096 (train-cstp's CSTPConfig(text_dim=4096)), at serve's
     defaults (cli/main.py:944-1000: 16 slots, max_len 1024, 8 steps a
     tick) plus prefill buckets up to 384 (the byte tokenizer's professor
     prompt is ~270 tokens), cache_system_prefix=True and a two-adapter
     bank with one spare row, on 127.0.0.1 at an ephemeral port: 16
     concurrent POST /v1/annotate (T=0.1, top_p=0.7, 64 new tokens, 4 on
     each adapter), /v1/chat/completions blocking and SSE (a protein part;
     greedy: the streamed text must equal the blocking text),
     /v1/completions routed to an adapter by `model`, /v1/embeddings (a
     protein and a text: finite, the CSTP dimension), GET /v1/models,
     /v1/adapters, /health and /metrics (the Prometheus completions
     counter and TTFT count equal the requests answered), then drain.
     Exact launch counts: flash_attention = 32 x (engine prefills + the
     text embedding), encoder kernels 33 x (protein requests + the
     protein embedding). Prints TTFT p50 / p99 and tok/s;
 11. training slice (`train-lora`): the earlier phases' LLM freed, a fresh
     Llama-3-8B drawn from the seed inside OpusConfig() (the ESM2, CSTP and
     switch of phase 4, frozen) trains LoRA adapters with train-lora's
     defaults (lr 2e-5, wd 0, batch 16, max-len 512, rank 16 / alpha 32
     on the seven projections, remat full, ce_chunk 0, grad_accum 1) on
     64 synthetic keywords-task records (proteins of 60-500 residues,
     24-64-token answers, instructions long enough that every batch
     reaches the 512-token cap, so the decoder runs at L = 512 + 8 - 1 =
     519, which the phase asserts) written to a temporary JSON and read
     through InstructionDataset -> instruction_batches ->
     multimodal_trainer.fit: (a) over the bf16 LLM for 4 steps, (b) over
     the same LLM through quantize_decoder4(layout="v1") (QLoRA, the bf16
     projections freed) for 3 steps. Exact launch counts per optimizer
     step: one ESM2 call of 16 proteins (each encoder kernel 33); the 32
     layers' forward and, under remat, their recompute in the backward
     (flash_attention 2 x 32, and with the v1 base int4_matmul_v1 2 x 7 x
     32 plus 1 for the vocab head, which is outside the remat: 449); one
     backward of each attention (flash_attention_bwd_dq = _dkv = 32); 0
     for every other kernel (the int4 backward dx is a dequantize + cuBLAS
     product, as in the JAX package). Checks: a finite loss every step and
     every LoRA B leaf changed after step 1. A gradient gate between (a)
     and (b): the LLM's first four layers and its head, 4 rows of the same
     traffic (their pooled ESM2 embeddings computed once), LoRA B drawn
     from N(0, 0.01); the `loss_fn` gradient of every LoRA leaf through
     the kernels (impl="auto", bf16) must stay within the bound of phase 3
     of the plain path in fp32 (impl="torch", fp32 weights), in units of
     each leaf's largest entry, printed next to the plain path in bf16.
     Prints s/step (steps after the first), trained tokens/s (the valid
     label tokens of a step over its wall time), GiB on the card after the
     weights are in place and the peak. After (a)'s timed steps, the
     checkpoint gates: the same state continues for 2 steps on the next
     two batches of the stream (a second epoch of the records) through
     fit(ckpt=core.checkpoint.CheckpointManager(tmp, max_to_keep=2),
     save_every=1), with (a)'s launch counts a step; only steps 5 and 6
     are kept and 6 is the latest; restore_state of step 6 into a fresh
     state equals the state in memory bit for bit (LoRA leaves, both
     Adam moments, their step counters, the schedule count, the step);
     step 6 taken again from the step-5 checkpoint on the same batch
     agrees with the one in memory within 1e-6 of each leaf's largest
     entry (the number of bit-identical leaves is printed); and
     core.convert.lora_to_peft(family="llama") gives 32 x 7 x 2 keys in
     (out, in) orientation that save_torch_state_dict and torch.load
     return unchanged.
 12. stage (a): the QLoRA LLM freed, a Llama-3-8B drawn in bf16 from the
     seed as the text LM beside phase 4's ESM2-650M; 384 synthetic
     UniProt records (unique proteins of 60-500 residues, captions of
     200-1792 ByteTokenizer tokens rendered by datasets.uniprot_text)
     written to a temporary pickle and run through
     data.precompute.precompute_cstp_pairs at its defaults (batch 8,
     len_bucket 128, max_text_len 4096, mask_pad=False). Checks exact
     launch counts (each encoder kernel 33 x ESM2 batches,
     flash_attention 32 x text batches, every other kernel 0), 384 finite
     fp32 pairs of 1280 / 4096, and that one text batch's text embeddings
     and one ESM2 batch's pooled embeddings through the kernels stay
     within phase 3's bound of the plain path in fp32 (printed beside the
     plain path in bf16). Then train-cstp's defaults
     (cli/main.py:1005-1025: lr 0.05, wd 1e-4, batch 128) through
     train.cstp_trainer.fit with CSTPConfig(protein_dim=1280,
     text_dim=4096, proj_dim=5120): 256 pairs x 2 epochs = 4 steps, a
     finite loss and accuracies in [0, 1] every step, evidence_dead
     printed, `evaluate` on the other 128; 2 more steps with
     fit(ckpt=CheckpointManager(tmp), save_every=1), restore_state of the
     last equal to the state in memory bit for bit; 2 with
     warmup_info_nce_steps=-1, each with a gradient norm > 0; before
     each of these two, the evidential loss (losses.trust_evidence, fp32)
     on the step's own similarities agrees with a plain fp64 reading of
     the same similarities within fp32's rounding bound for that sum
     (evidential_fp64). Prints the ESM2 and text seconds and rates,
     pairs/s, ms/step after the first and GiB on the card;
 13. families: Qwen2.5-7B (DecoderConfig.qwen25_7b()) and Galactica-6.7B
     (galactica_6_7b()), each drawn in bf16 from the seed in an
     OpusConfig whose switch is sized to its hidden size (3584 / 4096),
     answer 8 keywords requests through run_annotation_eval (one batch,
     32 new tokens, T=0.1, top_p=0.7) and embed 8 captions through
     models.text_encoder.text_embeddings. Checks exact launch counts
     (encoder kernels 33, flash_attention num_layers (28 / 32) for the
     prefill and again for the captions, every other kernel 0), that
     every request is answered, and that one prefill's last-position
     logits and the captions' embeddings through the kernels stay within
     phase 3's bound of the fp32 plain path. Prints entries/s, decode
     tok/s and GiB on the card;
 14. cli: the port's command line in this process,
     opus_pllm_tpu_torch.cli.main.main(["annotate", ...]) with
     --model-base <tmp>/Meta-Llama-3-8B (no such directory: the
     llama3_8b() preset, drawn at random on the card, with ESM2-650M in
     bf16, CSTP and the switch at their published widths) on 8 synthetic
     keywords requests, 16 new tokens, one batch; the card has no
     transformers, so cli.main.load_tokenizer returns ByteTokenizer() (a
     printed line says so) and nothing else of _build changes. Three
     runs: --num-beams 4 --temperature 0; --draft-layers 8 --n-draft 4
     --temperature 0; --load-int4 --quantize-cache int4 --num-beams 4.
     The CLI decodes on fused projections (4 products a layer).
     Gates: every request answered in --save-path; exact launch counts
     (encoder kernels 33, flash 32 for the prefill; the draft run 32 + 8
     + 32 a verify pass; the int4 run int4_matmul 1 + 129 a beam step
     and decode_attention_int4 32 a step); on each beam run's batch
     num_beams = 1 gives greedy's tokens, and every token of every
     returned hypothesis ranks within the top 2K of a teacher-forced pass
     on the fp32 plain path, up to twice the prefill's logit bound (a
     token that 2K others of its parent beat cannot be a candidate); the
     draft run's verify pass (B 8, Sq 4, cap l + 16 + 4) through the
     kernels within phase 3's bound of the fp32 plain path, and every
     emitted token within twice that bound of a teacher-forced prefill's
     argmax; one reorder_cache of 32 rows of a bf16, int8 and int4 cache
     equal to index_select on every leaf and the mask; the kernels at
     the new shapes each held against its plain version on the same
     inputs within phase 3's bound (int4 v2 at M = 32 on the five fused
     Llama-3-8B (K, N), int8 at the fused widths, both decode attentions
     over 32 reordered rows, flash at the static verify mask), timed
     beside their bound. Prints each run's beam or speculative tokens/s
     and ms a step, then the median and range of 5 reruns of the
     captured generation call on the same batch, tokens a verify pass,
     and the reorder's device time a step beside its bytes;
 15. loaders: files written here at full width, 2 layers: a HF
     Llama-3-8B-width directory (config.json, two .safetensors shards by
     this script's own writer), a fair-esm .pt (1280 wide), the
     reference weights directory (CSTP Lightning ckpt, a linear switch
     .bin, lora_adapter/ rank 16 on the seven projections with
     adapter_config.json), and a bitsandbytes NF4 double-quant state dict
     of one layer's projections quantized here. Gates: load_pretrained's
     tensors equal the written ones after the documented casts; the
     merged LoRA equals W + (alpha / r) A B in fp32 within one bf16
     rounding; the NF4 dequantization equals this script's decoding
     exactly; convert-weights through the CLI, then load_native, bit for
     bit; POST /v1/adapters with the PEFT directory on a live OpusServer,
     one greedy request through it equal to the in-memory bank's;
     fuse_projections of the int8 and int4 trees (an 8 x 64 prefill and
     a decode step through the kernels within phase 3's bound of the fp32
     plain path, 4 quantized products a layer instead of 7, the int4
     step's device and as-issued time unfused and fused); train-lora
     through the CLI for 2 steps with --save-every 1
     --export-reference-format, then --resume for a third, then 2 steps
     with --load-int4 (the v1 kernel): exact launch counts and a finite
     loss;
 16. parallel (serving): 4 ranks spawned on this one card (gloo: NCCL
     refuses two ranks on one device; the run prints the backend and
     that the ranks share the card), each running `annotate` through
     the port's CLI at full width (Llama-3-8B, ESM2-650M in bf16, random
     weights drawn per rank from the single process's seeds, the byte
     tokenizer): (a) --mesh 1,4 in bf16, 8 requests; (b) --mesh 2,2
     --load-int4 --quantize-cache int4; (c) --engine --mesh 1,4
     --load-int8 --quantize-cache int8; (d) --seq-shards 4 --load-int8
     on two ~4k-token prompts, with a bf16 and with an int8 cache. Gates,
     against one process on this card drawing the same LLM: the first
     step's logits (or the engine's first prefill group's) within phase
     3's bound of the fp32 plain path, every greedy token within twice
     that bound of a teacher-forced prefill's argmax, the tokens equal
     across the ranks that generate together, every request answered,
     exact launch counts a step per rank, each rank's LLM share 1/M of
     the projections and head, its peak within its share, its cache and
     4 GiB of working set (printed per rank); then every kernel of the
     runs at its shard shapes against its plain version (`compare`),
     with the variant it takes. A rank that raises or hangs fails the
     phase. The collectives' host-clock times and the runs' walls
     measure this rehearsal on one card, not tensor-parallel speed.
 17. parallel (training and serve): 4 ranks spawned as in phase 16, each
     running through the port's CLI: (a) train-lora --mesh 2,2 over a
     bf16 Llama-3-8B and (b) over its int4 v1 quantization (--load-int4:
     QLoRA), 2 steps each of train-lora's defaults (batch 16 at L = 519,
     LoRA rank 16 on the seven projections, remat full), the frozen tree
     FSDP-cut over the data pair and the LLM tensor-parallel over the
     model pair; when the ranks share one card at 8 of the 32 layers
     and with the chunked cross-entropy (--ce-chunk 64): four ranks'
     full-vocabulary fp32 logits, gathered weights and fp32 switches
     overflow one card (PERF.md); with a card a rank at 32 layers and
     train-lora's whole-sequence cross-entropy; (c)
     train-cstp --mesh 4 on 256 pairs of ESM2-650M / Llama-3-8B widths,
     batch 128, 2 steps; (d) serve --mesh 1,4 --load-int8
     --cache-system-prefix with an adapter bank of one PEFT directory and
     a spare row, at 32 layers: rank 0 takes 8 HTTP requests (4 greedy
     annotate requests at once, a greedy and a sampled generate, one
     cancelled by its timeout, one adapter added from a PEFT directory)
     and one greedy request under the new adapter, then SIGTERM. Gates,
     step 1 against one process running the same command on the same
     batches here, each later step against one process resumed from the
     mesh's checkpoint of the step before (the same parameters and
     moments): the loss (within 2^-7 in bf16, 1e-5 in fp32 (CSTP), with
     every CSTP metric within 1e-3), the gradients AdamW took (each leaf
     within 2^-4 of its largest entry in bf16, 1e-4 in fp32), step 1's
     sign rule on the parameters (an entry moves the other way only where
     one process's gradient lies within that bound of 0), the later
     updates from the same state (every entry within 2 lr, at most 1% of
     them beyond lr / 10); train-lora's losses at every step also within
     2^-7 of the first one process's; exact launch counts a step on every
     rank; the bf16 run's checkpoint (the mesh's full tree,
     in one process's format) equals its final tree bit for bit and one
     process resumes it for a third step; serving: every request answered
     as asked (504 for the cancelled one, the adapter listed, one
     cancellation in /health), rank 0 drained, every rank exited 0, the
     ranks' launch counts equal, the first prefill group's logits within
     phase 3's bound of the fp32 plain path and every greedy token within
     twice that bound of a teacher-forced argmax of one process's LLM;
     then the training shards' kernels against their plain versions
     (`compare`): flash forward and both backward kernels with 16 query
     and 4 KV heads at a data rank's 8 x 519 rows, int4_matmul_v1 at M =
     8 x 519 on the M = 2 shards.
     Each phase prints its wall, then chip_smoke prints its total.
The last two lines: a JSON object of the kernels' numbers, then
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --parallel

runs phases 1 and 2, then phases 16 and 17 alone (on a machine with four
cards, over NCCL with a card a rank: train-lora at 32 layers; phase 17
times one process's train steps beside the mesh's), then the
single-card baseline of phase 16's run (a) on one process. It prints no
result line.

    python3 chip_smoke.py --profile-serving

runs phases 1 and 2, then the serving configuration of phase 8 (bf16
cache, 32 requests) twice unprofiled, then its first 16 requests (one
wave: one prefill, 64 decode steps) under torch.profiler, and prints
where the device time goes: the kernels' summed device time against the
profiled wall time (the profiler inflates host time), the sums for the
casts and multiplies (mostly the dequantize route's), the hand-written
kernels and cuBLAS, and the kernels with the most device time. It checks
nothing and prints no result line.

    python3 chip_smoke.py --profile-training

runs phases 1 and 2, then phase 11's configuration: two unprofiled steps
and one profiled step of train-lora over the bf16 LLM, then the same over
its v1 quantization, each printed as above with the sums for the
hand-written kernels, cuBLAS, the elementwise casts / multiplies / adds
and the softmax kernels. It checks nothing and prints no result line.

    python3 chip_smoke.py --kernel-times [TREE ...]

times the kernels of each checkout TREE (default: this one; each in a
process of its own, which builds that tree's kernels into its git-ignored
build/), inputs drawn from the same seed, one device time per line (as
phase 3 times a kernel) with the card's name and power limit:
  - the flash-attention kernels at phase 3's flash shapes: the forward at
    all seven with SDPA on the same inputs and mask beside it, dq and
    dk/dv at the training shape and causal 2048;
  - the four encoder kernels at B=8, S in {128, 512} on phase 3's inputs,
    each with its bound and share: encoder_attention beside SDPA on the
    same inputs and key mask, ln_qkv_rope, out_proj and ffn beside the
    bf16 cuBLAS products they contain at the same (M, K, N) (marked *: not
    the same function);
  - int4_matmul (v2) at M=8 on the five decode shapes and at M in {1, 16,
    64} on 4096->14336, with the weights cold (the calls rotate over
    copies of the words and scales larger than the 50 MB L2 together, as
    a decode step streams 4 GB of them), each with its bound, then the
    sum of one decode step's 225 launches at M=8;
  - decode_attention_int8 / _int4 at phase 3's three shapes with the cache
    cold (rotated over copies past the L2), each with its bound, SDPA over
    a bf16 cache dequantized beforehand (marked *: not the same function)
    and, at B=8, one decode step's 32 launches; then the floor at one
    (row, KV head) over one 64-slot tile.
Naming the parent's checkout and this one in turns (parent, change,
change, parent) compares two designs on one card. It checks nothing and
prints no result line.

    python3 chip_smoke.py --flash-times [TREE ...]
    python3 chip_smoke.py --decode-times [TREE ...]
    python3 chip_smoke.py --encoder-times [TREE ...]

the same for the flash-attention kernels only, the decode attentions
only, or the four encoder kernels only.
"""

import json
import os
import subprocess
import sys
import time

ATOL = 4e-3
SEED = 0
B, E, H, F = 8, 1280, 20, 5120
TPU_KERNELS = {   # the Pallas call each CUDA kernel replaces
    "ln_qkv_rope": "opus_pllm_tpu/kernels/fused_encoder.py:107",
    "encoder_attention": "opus_pllm_tpu/kernels/fused_encoder.py:228",
    "out_proj": "opus_pllm_tpu/kernels/fused_encoder.py:380",
    "ffn": "opus_pllm_tpu/kernels/fused_encoder.py:323",
}
QUANT_KERNELS = {
    "int4_matmul": ("opus_pllm_tpu/kernels/quant4.py:392",
                    "opus_pllm_tpu_torch/csrc/int4_matmul.cu"),
    "decode_attention_int8": (
        "opus_pllm_tpu/kernels/decode_attention.py:126",
        "opus_pllm_tpu_torch/csrc/decode_attention.cu"),
    "decode_attention_int4": (
        "opus_pllm_tpu/kernels/decode_attention.py:234",
        "opus_pllm_tpu_torch/csrc/decode_attention.cu"),
}
SERVE_KERNELS = {
    "flash_attention": ("opus_pllm_tpu/kernels/flash_attention.py:257",
                        "opus_pllm_tpu_torch/csrc/flash_attention.cu"),
    "int8_matmul": ("opus_pllm_tpu/kernels/quant.py:142",
                    "opus_pllm_tpu_torch/csrc/int8_matmul.cu"),
}
TRAIN_KERNELS = {
    "flash_attention_bwd_dq": (
        "opus_pllm_tpu/kernels/flash_attention_bwd.py:197",
        "opus_pllm_tpu_torch/csrc/flash_attention_bwd.cu"),
    "flash_attention_bwd_dkv": (
        "opus_pllm_tpu/kernels/flash_attention_bwd.py:211",
        "opus_pllm_tpu_torch/csrc/flash_attention_bwd.cu"),
    "int4_matmul_v1": ("opus_pllm_tpu/kernels/quant4.py:359",
                       "opus_pllm_tpu_torch/csrc/int4_matmul_v1.cu"),
}
SOURCE = "opus_pllm_tpu_torch/csrc/fused_encoder.cu"
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256))          # (K, N) of one Llama-3-8B decode step
INT8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
ATTN_SHAPES = ((8, 391), (32, 2048))    # (B, capacity); Hq 32, Hkv 8, D 128
# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SERVE_REQUESTS = 32
SERVE_SLOTS, SERVE_STEPS = 16, 4
MCQ_REQUESTS = 16
# train-lora (cli/main.py:1027-1069): batch 16 at --max-len 512; one
# protein's 8 soft tokens replace its sentinel, so the decoder sees 519
TRAIN_BATCH, TRAIN_MAX_LEN = 16, 512
TRAIN_LEN = TRAIN_MAX_LEN + 8 - 1
TRAIN_RECORDS, TRAIN_STEPS_BF16, TRAIN_STEPS_QLORA = 64, 4, 3
TRAIN_STEPS_CKPT = 2            # the checkpointed steps after the timed ones
GATE_LAYERS, GATE_ROWS = 4, 4
# stage (a): precompute-pairs over synthetic UniProt records, then
# train-cstp's defaults (cli/main.py:1005-1025) on 256 of the pairs
STAGE_A_RECORDS, STAGE_A_TRAIN, STAGE_A_EPOCHS = 384, 256, 2
TEXT_LEN = 1792                 # the longest caption's 128-token bucket
FAMILY_REQUESTS = 8
# the engine options (phase 9) and the server (phase 10)
SPEC_DRAFT, SPEC_K = 8, 4       # draft_layers, spec_k
BANK_REQUESTS = 24
CHUNK, CHUNK_CAP = 256, 1024    # chunk_prefill, the chunked engine's max_len
# serve's defaults (cli/main.py:944-1000): 16 slots, max_len 1024, 8 steps
SERVER_SLOTS, SERVER_LEN, SERVER_STEPS = 16, 1024, 8


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_PHASE = [None, 0.0]      # the phase running and its start


def phase(msg):
    """Start a phase; print the wall of the one before it."""
    now = time.perf_counter()
    if _PHASE[0] is not None:
        print(f"   ({_PHASE[0]}: wall {now - _PHASE[1]:.1f} s)", flush=True)
    _PHASE[:] = [msg, now]
    print(f"== {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, hold=True):
    """Mean ms per call between CUDA events around `iters` calls, after 3
    warm-up calls. hold=True first queues a ~50 ms sleep on the device so
    that the host has enqueued every call before the device reaches them:
    the device's time for the calls. hold=False times the calls as the
    host issues them, which is the per-call cost where the host's launch
    rate is the slower side."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(100_000_000)     # ~50 ms of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_modules():
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant, quant4
    return fe, quant4, da, fa, quant, fab


def reset_counts():
    for mod in _kernel_modules():
        mod.reset_launches()


def read_counts():
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launches)
    return counts


def expect_counts(label, counts, **want):
    """Every kernel's launch count against `want` (names not given: 0)."""
    full = {name: want.get(name, 0) for name in counts}
    print(f"{label}: launches {counts}", flush=True)
    if counts != full:
        fail(f"{label}: launches {counts}, expected {full}")


def nbytes(*ts):
    import torch
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_ms(flops, n_bytes):
    """The least time the card could take: (ms, what bounds it)."""
    ops = 1e3 * flops / PEAK_BF16_FLOPS
    mem = 1e3 * n_bytes / PEAK_HBM_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def compare(name, kern, plain, bf_in, card, extra=(), *, flops,
            more_bytes=0, n_bytes=None, library=None, route=None,
            earlier=None, cublas=None, scaled_atol=False):
    """The kernel vs its plain version on the same inputs (module
    docstring, phase 3); `extra` arguments are passed as they are.
    `flops` and the bytes of the inputs, the output and `more_bytes`
    (operands the calls capture), or `n_bytes` where the data needs fewer
    (keys of padding that are never read), give the bound; `library` is the PyTorch
    yardstick, `route` another path of the port (its time is kept as
    route_ms), `earlier` the kernel's earlier design, `cublas` the bare
    cuBLAS products of a fused kernel (printed, marked *: not the same
    function), all only timed.
    scaled_atol: ATOL times max(1, max|plain_fp32|) (gradients). Returns
    the kernel's row of the JSON line, device times."""
    import torch
    ref32 = plain(*(t.float() for t in bf_in), *extra).float()
    ref_bf = plain(*bf_in, *extra).float()
    out = kern(*bf_in, *extra)
    torch.cuda.synchronize()
    if out.shape != ref32.shape or not torch.isfinite(out).all():
        fail(f"{name}: shape {tuple(out.shape)} or non-finite")
    err = (out.float() - ref32).abs().max().item()
    err_plain = (ref_bf - ref32).abs().max().item()
    tol = 2 * err_plain + ATOL * (
        max(1.0, ref32.abs().max().item()) if scaled_atol else 1.0)
    b_ms, b_by = bound_ms(flops, n_bytes if n_bytes is not None else
                          nbytes(*bf_in, *extra, out) + more_bytes)
    del ref32, ref_bf, out
    ms = time_ms(lambda: kern(*bf_in, *extra))
    plain_ms = time_ms(lambda: plain(*bf_in, *extra))
    call_ms = time_ms(lambda: kern(*bf_in, *extra), hold=False)
    lib_ms = time_ms(library) if library is not None else None
    route_ms = time_ms(route) if route is not None else None
    earlier_ms = time_ms(earlier) if earlier is not None else None
    cublas_ms = time_ms(cublas) if cublas is not None else None
    print(f"{name:38s} max_abs_err={err:.3e} (tol {tol:.3e}, plain bf16 "
          f"err {err_plain:.3e}) kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms"
          + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else "")
          + (f"  dequantize route {route_ms:.4f} ms"
             if route_ms is not None else "")
          + (f"  earlier kernel {earlier_ms:.4f} ms"
             if earlier_ms is not None else "")
          + (f"  cuBLAS* {cublas_ms:.4f} ms" if cublas_ms is not None
             else "")
          + f"  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
          f"{100 * b_ms / ms:.1f}% of it)  (kernel per call as issued "
          f"{call_ms:.4f} ms)  [{card}]", flush=True)
    if not err <= tol:
        fail(f"{name}: error {err:.3e} above {tol:.3e}")
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    if route is not None:
        res["route_ms"] = route_ms
    return res


def earlier_kernel(name, x, w, scale):
    """A call of the kernel that `name` keeps for unaligned N (its earlier
    design), made directly at an aligned shape so that phase 3 times the
    two designs in one run; not counted in `launches`."""
    import torch
    from opus_pllm_tpu_torch.kernels import build, quant4
    lib = build.library(name)
    fn = getattr(lib, f"opus_{name}_unaligned")
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if name == "int4_matmul":                  # v2: its split-K workspace
        n_sb = k // quant4.SUPER
        splits = quant4._splits(n_sb, -(-n // quant4.KERNEL_COLS)
                                * -(-m // quant4.KERNEL_MT))
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x.device)
        args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), ws.data_ptr(),
                out.data_ptr(), m, n, k, -(-n_sb // splits), splits, 1)
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: build.check(fn(*args, stream), name, lib)
    args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k) + ((0,) if name == "int4_matmul_v1" else ())
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: build.check(fn(*args, stream), name, lib)


def keep(rows, name, res, main):
    """Fold one shape's result into the kernel's JSON row: the largest
    error over its shapes, the times of its `main` shape."""
    row = rows.setdefault(name, {"max_abs_err": 0.0})
    err = max(row["max_abs_err"], res["max_abs_err"])
    if main:
        row.update(res)
    row["max_abs_err"] = err


def check_quant_kernels(card):
    """int4_matmul and both decode attentions at the quantized slice's
    shapes; the first shape of each is the one kept for the JSON line."""
    import torch
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = {}
    for i, (k, n) in enumerate(INT4_SHAPES):
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((8, k), generator=g, device="cuda").bfloat16()
        keep(rows, "int4_matmul", compare(
            f"int4_matmul M=8 K={k} N={n}",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
            flops=2 * 8 * k * n, more_bytes=nbytes(packed, s),
            earlier=earlier_kernel("int4_matmul", x, packed, s)), i == 0)
        del packed, s
        torch.cuda.empty_cache()
    hq, hkv, d = 32, 8, 128
    for i, (label, b, cap, mask4) in enumerate(attn_cases(g)):
        q = (torch.randn((b, 1, hq, d), generator=g, device="cuda")
             * 0.5).bfloat16()
        valid = mask4.sum().item()
        for kind, quant, fn in (
                ("int8", decoder._quantize_kv, da.decode_attention_int8),
                ("int4", decoder._quantize_kv4, da.decode_attention_int4)):
            kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
                (b, cap, hkv, d), generator=g, device="cuda")).items()}
                for _ in range(2))
            keep(rows, f"decode_attention_{kind}", compare(
                f"decode_attention_{kind} {label}",
                lambda q: fn(q, kl, vl, mask4),
                lambda q: da.decode_attention_plain(q, kl, vl, mask4), (q,),
                card, flops=4 * hq * d * valid,
                n_bytes=decode_bytes(q, kl, vl, mask4)), i == 0)
    return rows


def attn_cases(g):
    """The decode attention shapes, masks drawn from `g`: (label, B, cap,
    mask4). ATTN_SHAPES with lengths uniform over cap/2..cap, then the
    static decode's mask at B = 8 over 391 slots: prompts of 100-327 tokens
    left-padded to 327, and 32 of the 64 decode slots written (the rest an
    unwritten tail)."""
    import torch
    cases = []
    for b, cap in ATTN_SHAPES:
        lengths = torch.randint(cap // 2, cap + 1, (b,), generator=g,
                                device="cuda")
        mask = torch.arange(cap, device="cuda")[None] < lengths[:, None]
        cases.append((f"B={b} cap={cap}", b, cap, mask[:, None, None, :]))
    pad = 327 - torch.randint(100, 328, (8,), generator=g, device="cuda")
    slots = torch.arange(391, device="cuda")[None]
    mask = (slots >= pad[:, None]) & (slots < 327 + 32)
    cases.append(("static B=8 cap=391", 8, 391, mask[:, None, None, :]))
    return cases


def decode_bytes(q, kl, vl, mask4):
    """The bytes decode attention must move: q, out and the mask once, and
    the K and V rows and scales of the valid slots only."""
    b, cap = mask4.shape[0], mask4.shape[-1]
    share = mask4.sum().item() / (b * cap)
    return 2 * nbytes(q) + nbytes(mask4) + share * nbytes(*kl.values(),
                                                         *vl.values())


FIRST_FLASH_CASES = 4


def flash_generators():
    """(g, g_more) for flash_cases, seeded from SEED and SEED + 2."""
    import torch
    g, g_more = (torch.Generator(device="cuda") for _ in range(2))
    g.manual_seed(SEED)
    g_more.manual_seed(SEED + 2)
    return g, g_more


def flash_cases(g, g_more):
    """phase 3's flash_attention shapes: (label, B, Sq, Skv, mask, causal,
    Hq, Hkv). The first FIRST_FLASH_CASES draw their masks from `g`; the
    cases after them draw from `g_more` (as their q, k, v do), so that
    adding a case moves none of `g`'s draws."""
    import torch
    from opus_pllm_tpu_torch.serve.engine import admission_inputs
    # serving prefill: 16 admitted prompts of 200-320 spliced tokens
    n_valid = torch.randint(200, 321, (16,), generator=g, device="cuda")
    n_valid[0] = 287
    _, serve_mask = admission_inputs(n_valid, 320)
    # static prefill: 8 left-padded prompts of 327 tokens over 391 slots,
    # the 64 decode slots not yet written
    pad = 327 - torch.randint(100, 328, (8,), generator=g, device="cuda")
    cols = torch.arange(391, device="cuda")[None, None, None, :]
    rows_q = torch.arange(327, device="cuda")[None, None, :, None]
    static_mask = (cols <= rows_q) & (cols >= pad[:, None, None, None])
    # training: train-lora's batch at L = 519, right-padded
    n_train = torch.randint(TRAIN_LEN // 2, TRAIN_LEN + 1, (TRAIN_BATCH,),
                            generator=g, device="cuda")
    n_train[0] = TRAIN_LEN
    # the text encoder's prefill: 8 right-padded captions in a 1792 bucket
    n_text = torch.randint(TEXT_LEN // 8, TEXT_LEN + 1, (8,),
                           generator=g_more, device="cuda")
    n_text[0] = TEXT_LEN
    return (("serving prefill B=16 S=320", 16, 320, 320, serve_mask, False,
             32, 8),
            ("static prefill B=8 327x391", 8, 327, 391, static_mask, False,
             32, 8),
            ("causal B=1 S=2048", 1, 2048, 2048, None, True, 32, 8),
            (f"training B={TRAIN_BATCH} L={TRAIN_LEN}", TRAIN_BATCH,
             TRAIN_LEN, TRAIN_LEN, train_mask(n_train, TRAIN_LEN), False,
             32, 8),
            (f"text encoder B=8 S={TEXT_LEN}", 8, TEXT_LEN, TEXT_LEN,
             train_mask(n_text, TEXT_LEN), False, 32, 8),
            # the families' static prefills: Qwen2.5-7B (28 / 4 heads,
            # G = 7) and Galactica-6.7B (32 / 32, G = 1)
            ("qwen2 static prefill G=7 327x391", 8, 327, 391, static_mask,
             False, 28, 4),
            ("opt static prefill G=1 327x391", 8, 327, 391, static_mask,
             False, 32, 32))


def kernel_times(flag, trees):
    """--kernel-times / --flash-times / --decode-times / --encoder-times
    (module docstring): each tree in a process of its own, or, for one
    tree, its kernels' device times."""
    if len(trees) != 1:
        for tree in trees:
            subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                            tree], check=True, timeout=900)
        return
    import torch
    tree = os.path.abspath(trees[0])
    sys.path.insert(0, tree)
    import opus_pllm_tpu_torch
    pkg = os.path.dirname(os.path.dirname(
        os.path.abspath(opus_pllm_tpu_torch.__file__)))
    if pkg != tree:
        fail(f"imported {pkg}, not the package of {tree}")
    from opus_pllm_tpu_torch.kernels import build
    card = card_line()
    build.build_all()
    if flag == "--decode-times":
        decode_attention_times(tree, card)
        return
    if flag == "--encoder-times":
        encoder_times(tree, card)
        return
    flash_kernel_times(tree, card)
    if flag == "--kernel-times":
        encoder_times(tree, card)
        int4_times(tree, card)
        decode_attention_times(tree, card)


def flash_kernel_times(tree, card):
    """The flash kernels at phase 3's flash shapes, the forward with SDPA
    on the same inputs and mask beside it (K/V heads repeated
    beforehand)."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    g, g_more = flash_generators()
    d = 128
    for i, (label, b, sq, skv, mask, causal, hq, hkv) in enumerate(
            flash_cases(g, g_more)):
        gq = g if i < FIRST_FLASH_CASES else g_more
        rnd = lambda *shape: torch.randn(shape, generator=gq,
                                         device="cuda").bfloat16()
        q, k, v = rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, mask,
                                                causal=causal))
        kx, vx = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        qx = q.transpose(1, 2)
        sdpa = time_ms(lambda: tnf.scaled_dot_product_attention(
            qx, kx, vx, attn_mask=mask, is_causal=causal))
        print(f"{tree}: flash_attention {label}: {ms:.4f} ms (SDPA "
              f"{sdpa:.4f} ms) [{card}]", flush=True)
        del kx, vx, qx
        if label.startswith(("training", "causal")):
            dout = rnd(b, sq, hq, d)
            out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                          return_lse=True)
            delta = fab._delta(out, dout)
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                fn = getattr(fab, name)
                ms = time_ms(lambda: fn(q, k, v, mask, lse, delta, dout,
                                        causal=causal))
                print(f"{tree}: {name} {label}: {ms:.4f} ms [{card}]",
                      flush=True)


def encoder_times(tree, card):
    """The four encoder kernels at B = 8, S in {128, 512} on phase 3's
    inputs (ragged key rows, one unpadded), each with its bound and share,
    SDPA beside the attention and the bare cuBLAS products beside
    ln_qkv_rope, out_proj and ffn (marked *: not the same function)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    for s in (128, 512):
        for (name, kern, _, bf_in, extra, flops, lib, n_bytes,
             cublas) in kernel_cases(s, g):
            out = kern(*bf_in, *extra)
            b_ms, b_by = bound_ms(flops, n_bytes if n_bytes is not None
                                  else nbytes(*bf_in, *extra, out))
            del out
            ms = time_ms(lambda: kern(*bf_in, *extra))
            yard = ""
            if lib is not None:
                yard = f", SDPA {time_ms(lib):.4f} ms"
            if cublas is not None:
                yard = f", cuBLAS* {time_ms(cublas):.4f} ms"
            print(f"{tree}: {name} B={B} S={s}: {ms:.4f} ms{yard}, bound "
                  f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / ms:.1f}% of it) "
                  f"[{card}]", flush=True)


INT4_TIMES = tuple((8, k, n) for k, n in INT4_SHAPES) + tuple(
    (m, 4096, 14336) for m in (1, 16, 64))
COLD_BYTES = 120e6          # > the H100's 50 MB L2, as a decode step finds it


def int4_times(tree, card):
    """int4_matmul (v2) at M = 8 on the five decode shapes and M in {1, 16,
    64} on 4096->14336, the weights cold: the calls rotate over copies of
    the words and scales that together exceed the L2 (COLD_BYTES), as a
    decode step streams 4 GB of them. Then the sum of one Llama-3-8B
    decode step (32 x the seven projections + the head) at M = 8."""
    import itertools
    import torch
    from opus_pllm_tpu_torch.kernels import quant4
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    step = {(4096, 4096): 2 * 32, (4096, 1024): 2 * 32,
            (4096, 14336): 2 * 32, (14336, 4096): 32, (4096, 128256): 1}
    total = total_bound = 0.0
    for m, k, n in INT4_TIMES:
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        copies = max(1, int(-(-COLD_BYTES // nbytes(packed, s))))
        weights = [(packed, s)] + [(packed.clone(), s.clone())
                                   for _ in range(copies - 1)]
        out = quant4.int4_matmul(x, packed, s)
        b_ms, b_by = bound_ms(2 * m * k * n, nbytes(x, packed, s, out))
        turn = itertools.cycle(weights)
        ms = time_ms(lambda: quant4.int4_matmul(x, *next(turn)))
        print(f"{tree}: int4_matmul M={m} K={k} N={n}: {ms:.4f} ms (weights "
              f"cold, {copies} copies), bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / ms:.1f}% of it) [{card}]", flush=True)
        if m == 8:
            total += step[(k, n)] * ms
            total_bound += step[(k, n)] * b_ms
        del weights, packed, s, turn
        torch.cuda.empty_cache()
    print(f"{tree}: int4_matmul one decode step at M=8 (225 launches): "
          f"{total:.4f} ms, bound {total_bound:.4f} ms "
          f"({100 * total_bound / total:.1f}% of it) [{card}]", flush=True)


def decode_attention_times(tree, card):
    """Both decode attentions at phase 3's shapes (attn_cases), the cache
    cold: the calls rotate over copies of the cache that together exceed
    the L2 (COLD_BYTES), as a decode step streams 32 layers' caches. Beside
    each: the bound, SDPA over a bf16 cache dequantized beforehand (K/V
    heads repeated; not the same function: the dequantize is not timed and
    the cache read is bf16), and, at B = 8, one decode step's 32 launches.
    Then the floor: one (row, KV head) over one 64-slot tile."""
    import itertools
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    hq, hkv, d = 32, 8, 128
    kinds = (("int8", decoder._quantize_kv, da.decode_attention_int8),
             ("int4", decoder._quantize_kv4, da.decode_attention_int4))
    for label, b, cap, mask4 in attn_cases(g):
        q = (torch.randn((b, 1, hq, d), generator=g, device="cuda")
             * 0.5).bfloat16()
        for kind, quant, fn in kinds:
            kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
                (b, cap, hkv, d), generator=g, device="cuda")).items()}
                for _ in range(2))
            copies = max(1, int(-(-COLD_BYTES // nbytes(*kl.values(),
                                                       *vl.values()))))
            caches = [(kl, vl)] + [
                tuple({key: t.clone() for key, t in leaf.items()}
                      for leaf in (kl, vl)) for _ in range(copies - 1)]
            b_ms, b_by = bound_ms(4 * hq * d * mask4.sum().item(),
                                  decode_bytes(q, kl, vl, mask4))
            turn = itertools.cycle(caches)
            ms = time_ms(lambda: fn(q, *next(turn), mask4))
            hot = time_ms(lambda: fn(q, kl, vl, mask4))
            kx, vx = (decoder._dequantize_kv(leaf, torch.bfloat16)
                      .repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                      .contiguous() for leaf in (kl, vl))
            qx = q.transpose(1, 2)
            lib = time_ms(lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask4))
            step = (f", one decode step (32 launches) {32 * ms:.4f} ms"
                    if b == 8 else "")
            print(f"{tree}: decode_attention_{kind} {label}: {ms:.4f} ms "
                  f"(cache cold, {copies} copies; hot {hot:.4f} ms), "
                  f"bound {b_ms:.4f} ms "
                  f"({b_by}; {100 * b_ms / ms:.1f}% of it), SDPA* on a bf16 "
                  f"cache {lib:.4f} ms{step} [{card}]", flush=True)
            del caches, turn, kx, vx
            torch.cuda.empty_cache()
    q = torch.randn((1, 1, 4, d), generator=g, device="cuda").bfloat16()
    mask4 = torch.ones((1, 1, 1, 64), dtype=torch.bool, device="cuda")
    for kind, quant, fn in kinds:
        kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
            (1, 64, 1, d), generator=g, device="cuda")).items()}
            for _ in range(2))
        ms = time_ms(lambda: fn(q, kl, vl, mask4))
        print(f"{tree}: decode_attention_{kind} floor (B=1, one KV head, "
              f"one 64-slot tile): {ms:.4f} ms [{card}]", flush=True)


def check_serve_kernels(card):
    """flash_attention and int8_matmul at the prefill shapes of the serving
    and static paths (module docstring, phase 3)."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import quant
    g, g_more = flash_generators()
    rnd = lambda *shape, gen=g: torch.randn(shape, generator=gen,
                                            device="cuda").bfloat16()
    rows = {}
    d = 128
    for i, (label, b, sq, skv, mask, causal, hq, hkv) in enumerate(
            flash_cases(g, g_more)):
        gq = g if i < FIRST_FLASH_CASES else g_more
        q, k, v = (rnd(b, sq, hq, d, gen=gq), rnd(b, skv, hkv, d, gen=gq),
                   rnd(b, skv, hkv, d, gen=gq))
        pairs = (mask.sum().item() if mask is not None
                 else b * sq * (sq + 1) // 2)
        kx, vx = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        qx = q.transpose(1, 2)
        keep(rows, "flash_attention", compare(
            f"flash_attention {label}",
            lambda q, k, v: fa.flash_attention(q, k, v, mask, causal=causal),
            lambda q, k, v: fa.flash_attention_plain(q, k, v, mask,
                                                     causal=causal),
            (q, k, v), card, flops=4 * hq * d * pairs,
            more_bytes=nbytes(mask),
            library=lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask, is_causal=causal)), i == 0)
        del q, k, v, kx, vx, qx
    g3, cases = option_flash_cases()
    for label, b, sq, skv, mask in cases:
        q, k, v = (rnd(b, sq, 32, d, gen=g3), rnd(b, skv, 8, d, gen=g3),
                   rnd(b, skv, 8, d, gen=g3))
        kx, vx = (t.repeat_interleave(4, dim=2).transpose(1, 2)
                  for t in (k, v))
        qx = q.transpose(1, 2)
        # the data's bytes: q and out, the mask, and the K / V rows some
        # query of the row may attend (the kernel skips the others' tiles)
        share = mask.any(2).float().mean().item()
        keep(rows, "flash_attention", compare(
            f"flash_attention {label}",
            lambda q, k, v: fa.flash_attention(q, k, v, mask),
            lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
            (q, k, v), card, flops=4 * 32 * d * mask.sum().item(),
            n_bytes=2 * nbytes(q) + nbytes(mask) + share * nbytes(k, v),
            library=lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask)), False)
        del q, k, v, kx, vx, qx
    for m in (5120, 2616):
        for k, n in INT8_SHAPES:
            wq, s = quant.quantize_per_channel(
                torch.randn((k, n), generator=g, device="cuda"))
            w_bf = (wq.float() * s).bfloat16()
            x = rnd(m, k)
            keep(rows, "int8_matmul", compare(
                f"int8_matmul M={m} K={k} N={n}",
                lambda x: quant.int8_matmul(x, wq, s),
                lambda x: quant.int8_matmul_plain(x, wq, s), (x,), card,
                flops=2 * m * n * k, more_bytes=nbytes(wq, s),
                library=lambda: torch.mm(x, w_bf),
                route=lambda: quant.dequant_matmul(x, wq, s),
                earlier=earlier_kernel("int8_matmul", x, wq, s)),
                (m, k, n) == (5120, 4096, 14336))
            del wq, s, w_bf, x
            torch.cuda.empty_cache()
    return rows


def train_mask(n_valid, length):
    """opus.forward's training mask: right-padded valid lengths (B,) and
    causality -> (B, 1, L, L) bool."""
    import torch
    from opus_pllm_tpu_torch.models.layers import causal_mask
    attn = (torch.arange(length, device=n_valid.device)[None]
            < n_valid[:, None])
    return causal_mask(attn)


def check_train_kernels(card):
    """Both flash-attention backward kernels and int4_matmul_v1 at the
    training slice's shapes (module docstring, phase 3)."""
    import torch
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    from opus_pllm_tpu_torch.kernels import quant4
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").bfloat16()
    rows = {}
    hq, hkv, d = 32, 8, 128
    n_valid = torch.randint(TRAIN_LEN // 2, TRAIN_LEN + 1, (TRAIN_BATCH,),
                            generator=g, device="cuda")
    n_valid[0] = TRAIN_LEN
    cases = ((f"training B={TRAIN_BATCH} L={TRAIN_LEN}", TRAIN_BATCH,
              TRAIN_LEN, train_mask(n_valid, TRAIN_LEN), False),
             ("causal B=1 S=2048", 1, 2048, None, True))
    for i, (label, b, s, mask, causal) in enumerate(cases):
        q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), \
            rnd(b, s, hkv, d), rnd(b, s, hq, d)
        out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                      return_lse=True)
        delta = fab._delta(out, dout)
        pairs = (mask.sum().item() if mask is not None
                 else b * s * (s + 1) // 2)
        plain = lambda q, k, v, dout: fab.flash_attention_bwd_plain(
            q, k, v, mask, out, lse, dout, causal=causal)
        # SDPA on (B, H, S, D) leaves, K/V heads repeated, backward only
        qx, kx, vx = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k.repeat_interleave(hq // hkv, dim=2),
                                v.repeat_interleave(hq // hkv, dim=2)))
        ox = torch.nn.functional.scaled_dot_product_attention(
            qx, kx, vx, attn_mask=mask, is_causal=causal)
        gx = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(ox, (qx, kx, vx), gx,
                                              retain_graph=True)
        saved = nbytes(mask, lse, delta)
        keep(rows, "flash_attention_bwd_dq", compare(
            f"flash_attention_bwd_dq {label}",
            lambda q, k, v, dout: fab.flash_attention_bwd_dq(
                q, k, v, mask, lse, delta, dout, causal=causal),
            lambda *a: plain(*a)[0], (q, k, v, dout), card,
            flops=6 * hq * d * pairs, more_bytes=saved, library=library,
            scaled_atol=True), i == 0)
        keep(rows, "flash_attention_bwd_dkv", compare(
            f"flash_attention_bwd_dkv {label}",
            lambda q, k, v, dout: fab.flash_attention_bwd_dkv(
                q, k, v, mask, lse, delta, dout, causal=causal),
            lambda *a: torch.stack(plain(*a)[1:]), (q, k, v, dout), card,
            flops=8 * hq * d * pairs, more_bytes=saved, library=library,
            scaled_atol=True), i == 0)
        del q, k, v, dout, out, lse, delta, qx, kx, vx, ox, gx
        torch.cuda.empty_cache()
    m = TRAIN_BATCH * TRAIN_LEN
    for k, n in INT4_SHAPES:
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4(q)
        del q
        w_bf = quant4.dequantize_bf16(packed, s)
        x = rnd(m, k)
        keep(rows, "int4_matmul_v1", compare(
            f"int4_matmul_v1 M={m} K={k} N={n}",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
            flops=2 * m * k * n, more_bytes=nbytes(packed, s),
            library=lambda: torch.mm(x, w_bf),
            route=lambda: quant4.dequant_matmul(x, packed, s),
            earlier=earlier_kernel("int4_matmul_v1", x, packed, s)),
            (k, n) == (4096, 14336))
        del packed, s, w_bf, x
        torch.cuda.empty_cache()
    return rows


def attention_bytes(qkv, mask):
    """The bytes encoder_attention must move: every query row and output
    row, the keys and values of valid keys only (a 64-key tile of padding
    is never loaded), the key mask."""
    _, b, h, s, d = qkv.shape
    row = h * d * qkv.element_size()
    return row * (2 * b * s + 2 * mask.sum().item()) + nbytes(mask)


def kernel_cases(s, g):
    """(name, kernel, plain, bf16 inputs, extra arguments, FLOP, library
    call or None, bytes or None, bare cuBLAS products or None) at B=8,
    sequence length s."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models.layers import rope_cos_sin
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        t = torch.randn(shape, generator=g, device=dev) * scale
        return t.to(torch.bfloat16)

    lengths = torch.randint(s // 4, s + 1, (B,), generator=g, device=dev)
    lengths[0] = s                                  # one row unpadded
    mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    ln = torch.stack([1 + 0.1 * torch.randn(E, generator=g, device=dev),
                      0.1 * torch.randn(E, generator=g, device=dev)]
                     ).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(s, device=dev), 64)
    x = rnd(B, s, E)
    qkv = rnd(3, B, H, s, 64)
    # every query against the valid keys of its row
    pairs = s * mask.sum().item()
    qkv_in = (x, rnd(3, E, E, scale=E ** -0.5), rnd(3, E, scale=0.1), ln)
    out_in = (rnd(B, s, E, scale=0.5), rnd(E, E, scale=E ** -0.5),
              rnd(E, scale=0.1), x)
    ffn_in = (x, rnd(E, F, scale=E ** -0.5), rnd(F, scale=0.1),
              rnd(F, E, scale=F ** -0.5), rnd(E, scale=0.1), ln)
    # the bare products at the kernels' (M, K, N): x . W_qkv as one (E, 3E)
    # matrix; a . W_o; x . W1, then a bf16 (M, F) hidden . W2 (its own
    # generator: the draws above stay those of the kernels' inputs)
    x2 = x.reshape(B * s, E)
    a2 = out_in[0].reshape(B * s, E)
    w_cat = qkv_in[1].permute(1, 0, 2).reshape(E, 3 * E)
    hidden = torch.randn((B * s, F), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED)).to(torch.bfloat16)
    return [
        ("ln_qkv_rope", fe.ln_qkv_rope, fe.ln_qkv_rope_plain, qkv_in,
         (cos, sin), 2 * B * s * E * 3 * E, None, None, lambda: x2 @ w_cat),
        ("encoder_attention", fe.encoder_attention,
         fe.encoder_attention_plain, (qkv,), (mask,), 4 * H * 64 * pairs,
         lambda: tnf.scaled_dot_product_attention(
             qkv[0], qkv[1], qkv[2], attn_mask=mask[:, None, None, :]),
         attention_bytes(qkv, mask), None),
        ("out_proj", fe.out_proj, fe.out_proj_plain, out_in, (),
         2 * B * s * E * E, None, None, lambda: a2 @ out_in[1]),
        ("ffn", fe.ffn, fe.ffn_plain, ffn_in, (), 4 * B * s * E * F, None,
         None, lambda: (x2 @ ffn_in[1], hidden @ ffn_in[3])),
    ]


def check_kernels(card):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = {}
    for s in (128, 512):
        for (name, kern, plain, bf_in, extra, flops, lib,
             n_bytes, cublas) in kernel_cases(s, g):
            keep(rows, name, compare(f"{name} S={s}", kern, plain, bf_in,
                                     card, extra, flops=flops,
                                     n_bytes=n_bytes, library=lib,
                                     cublas=cublas), s == 512)
    return rows


KEYWORDS = ("Hydrolase", "Zinc", "Metal-binding", "Transferase",
            "ATP-binding", "Membrane", "Kinase")
FUNCTIONS = ("Catalyzes the hydrolysis of ATP to drive transport across "
             "membranes.", "Forms a channel that conducts potassium ions "
             "across the membrane.", "Acts as a chaperone assisting the "
             "folding of nascent polypeptides.")


def synthetic_examples(n, instruction="What are the UniProtKB keywords of "
                       "this protein?", answers=None):
    """n requests with proteins of 60-500 residues drawn from SEED; the
    ground truths cycle through `answers` (default: pairs of KEYWORDS) and
    draw nothing, so the proteins stay those of the seed."""
    import numpy as np
    from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    answers = answers or tuple(
        f"{KEYWORDS[i]}; {KEYWORDS[(i + 3) % len(KEYWORDS)]}"
        for i in range(len(KEYWORDS)))
    return [AnnotationExample(
        instruction, "".join(rng.choice(aa, int(rng.integers(60, 501)))),
        answers[i % len(answers)]) for i in range(n)]


def in_unit_range(values):
    import math
    return all(isinstance(v, float) and math.isfinite(v) and 0.0 <= v <= 1.0
               for v in values)


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_fp32(v) for v in tree]
    return tree.float()


def check_slice(card):
    import torch
    from opus_pllm_tpu_torch.core.config import (ESM2Config, GenerationConfig,
                                                 OpusConfig)
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import decoder, esm2, opus

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params = opus.init(cfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)

    tok = ByteTokenizer()
    examples = synthetic_examples(16)
    gen = GenerationConfig(max_new_tokens=64, temperature=0.1, top_p=0.7,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=SEED)
    batch = 8
    n_batches = -(-len(examples) // batch)
    reset_counts()
    rep = runner.run_annotation_eval(
        params, cfg, tok, "synthetic_keywords.json", gen=gen,
        batch_size=batch, examples=examples, log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("slice", counts, flash_attention=cfg.llm.num_layers
                  * n_batches, **{n: cfg.esm.num_layers * n_batches
                                  for n in fe.launches})
    if len(rep.results) != len(examples) or not all(
            isinstance(r["generated"], str) for r in rep.results):
        fail("the runner did not answer every request")
    m = rep.metrics
    if set(m) != {"Precision", "Recall", "F1 Score"} or not in_unit_range(
            m.values()):
        fail(f"keywords metrics {m}")
    print(f"slice metrics: {m}", flush=True)
    tok_s = rep.decode_tokens / rep.decode_seconds
    print(f"slice: {len(rep.results)} entries in {rep.seconds:.2f} s, "
          f"entries/s {rep.entries_per_sec:.3f}; decode {rep.decode_tokens} "
          f"tokens in {rep.decode_seconds:.2f} s = {tok_s:.1f} tok/s "
          f"(batch {batch}) [{card}]", flush=True)
    print(f"sample output: {rep.results[0]['generated'][:60]!r}", flush=True)

    # ESM2 through the kernels vs the plain layer composition in fp32
    toks, _ = esm2.tokenize([e.sequence for e in examples[:2]])
    toks = torch.from_numpy(toks).cuda()
    got = esm2.pooled_embedding(params["esm"], cfg.esm, toks, impl="auto")
    bf = esm2.pooled_embedding(params["esm"], cfg.esm, toks, impl="torch")
    esm32 = _to_fp32(params["esm"])
    ref = esm2.pooled_embedding(esm32, ESM2Config(), toks, impl="torch")
    err = (got - ref).abs().max().item()
    err_plain = (bf - ref).abs().max().item()
    print(f"esm2 pooled (2 proteins, 33 layers): kernels vs fp32 plain "
          f"{err:.3e}, bf16 plain vs fp32 plain {err_plain:.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= 2 * err_plain + ATOL):
        fail(f"ESM2 pooled embedding through the kernels is off: {err:.3e}")
    del esm32

    # decoder logits on the first spliced batch: finite, (B, V)
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples[:batch]],
        [e.sequence for e in examples[:batch]], prompt_bucket=64,
        esm_bucket=128, device="cuda")
    with torch.no_grad():
        sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks,
                                left_pad=True)
        hid, _ = decoder.forward(
            params["llm"], cfg.llm, sp.embeds,
            decoder.positions_from_mask(sp.mask),
            decoder.layers.causal_mask(sp.mask), return_hidden=True)
        logits = decoder.head_logits(params["llm"], cfg.llm, hid[:, -1])
    if logits.shape != (batch, cfg.llm.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"decoder logits {tuple(logits.shape)} not finite")
    print(f"decoder prefill logits {tuple(logits.shape)} finite, prompt "
          f"length {sp.embeds.shape[1]}", flush=True)
    return counts, params, cfg, examples, gen


def wordpiece_vocab():
    """A WordPiece vocab made here (no file is read): [PAD] [UNK] [CLS]
    [SEP], the printable ASCII characters and their ## forms, every id
    below BertConfig().vocab_size."""
    chars = [chr(c) for c in range(33, 127)]
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + chars + [
        "##" + c for c in chars]
    return {t: i for i, t in enumerate(toks)}


def check_function_metrics(card, params, cfg, gen):
    """8 function-task requests, one batch, through the bf16 slice's
    params, scored with BERTScore over a full-width BioBERT-large shape
    (random fp32 weights from SEED) on the card (module docstring, phase
    5)."""
    import torch
    from opus_pllm_tpu_torch.core.config import BertConfig
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.evals.metrics import bertscore_from_embeddings
    from opus_pllm_tpu_torch.evals.textproc import WordPieceTokenizer
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import bert

    bcfg = BertConfig()
    vocab = wordpiece_vocab()
    if max(vocab.values()) >= bcfg.vocab_size:
        fail("the WordPiece vocab does not fit BioBERT's embedding")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    before = torch.cuda.memory_allocated()
    bparams = bert.init(bcfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    gib = (torch.cuda.memory_allocated() - before) / 2**30
    embed = bert.make_embed_fn(bparams, bcfg, WordPieceTokenizer(vocab))
    spent = []

    def timed_embed(texts):
        t0 = time.perf_counter()
        out = embed(texts)
        spent.append(time.perf_counter() - t0)
        return out

    batch = 8
    examples = synthetic_examples(
        batch, "What is the function of this protein?", FUNCTIONS)
    reset_counts()
    rep = runner.run_annotation_eval(
        params, cfg, ByteTokenizer(), "synthetic_function.json", gen=gen,
        batch_size=batch, examples=examples, bert_embed_fn=timed_embed,
        log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("function metrics", counts,
                  flash_attention=cfg.llm.num_layers,
                  **{n: cfg.esm.num_layers for n in fe.launches})
    if len(rep.results) != batch:
        fail("the runner did not answer every function request")
    m = rep.metrics
    print(f"function metrics: {m}", flush=True)
    if set(m) != {"ROUGEScore", "BLEU", "METEOR", "BERTScore"} or \
            m["BERTScore"] is None or not in_unit_range(
                [*m["ROUGEScore"].values(), m["BLEU"], m["METEOR"],
                 *m["BERTScore"].values()]):
        fail(f"function metrics {m}")
    emb, mask = embed([ex.output for ex in examples[:3]])
    same = bertscore_from_embeddings(emb, mask, emb, mask)
    print(f"BERTScore of a text against itself {same}", flush=True)
    if abs(same["f1"] - 1.0) > 1e-5:
        fail(f"BERTScore of a text against itself is {same['f1']}")
    print(f"BioBERT-large shape ({bcfg.num_layers} x {bcfg.hidden_size}, "
          f"fp32): {gib:.2f} GiB on the card, {sum(spent):.2f} s to embed "
          f"{2 * batch} texts in {len(spent)} calls; {len(rep.results)} "
          f"entries in {rep.seconds:.2f} s [{card}]", flush=True)
    del bparams, embed
    torch.cuda.empty_cache()
    return counts


MCQ_QUESTIONS = (
    ("Which compartment hosts this protein?",
     ("Nucleus", "Plasma membrane", "Cytosol", "Golgi apparatus")),
    ("Which cofactor does this protein bind?", ("Zinc", "Magnesium",
                                                "Iron", "Copper")),
    ("Which enzyme class does this protein belong to?",
     ("Hydrolase", "Transferase", "Oxidoreductase", "Ligase")),
    ("What is the main function of this protein?",
     ("ATP-driven transport", "DNA repair", "Protein folding",
      "Signal transduction")))


def mcq_records(n):
    """n synthetic 4-option questions: proteins of 60-500 residues drawn
    from SEED, options "A) ..." to "D) ...", answers cycling through A-D."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [{"question": MCQ_QUESTIONS[i % 4][0],
             "options": [f"{c}) {o}" for c, o in
                         zip("ABCD", MCQ_QUESTIONS[i % 4][1])],
             "input": "".join(rng.choice(aa, int(rng.integers(60, 501)))),
             "answer": "ABCD"[(i + i // 4) % 4]} for i in range(n)]


def check_mcq_logits(params, cfg, tok, examples):
    """One batch's scored-MCQ logits (`runner._mcq_next_logits`) through
    the kernels (impl="auto", bf16) and plain (impl="torch", bf16) against
    the plain path in fp32 (ESM2 in fp32, the LLM with fp32 activations,
    embedding and norms; the same bf16 projections); then the chosen
    letters against the fp32 path's where the top two letters' scores
    differ by more than twice the bound."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    render = runner._mcq_renderer(tok, None)
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, [render(runner.ds.mcq_prompt(e.question, e.options))
              for e in examples], [e.sequence for e in examples],
        prompt_bucket=64, esm_bucket=128, device="cuda")
    got = runner._mcq_next_logits(params, cfg, ids, mask, esm_toks,
                                  impl="auto")
    plain = runner._mcq_next_logits(params, cfg, ids, mask, esm_toks,
                                    impl="torch")
    cfg32 = dataclasses.replace(
        cfg, esm=dataclasses.replace(cfg.esm, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))
    ref = runner._mcq_next_logits(
        dict(params, esm=_to_fp32(params["esm"]),
             llm=_norms_to_fp32(params["llm"])), cfg32, ids, mask, esm_toks,
        impl="torch")
    err = (got - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    bound = 2 * err_plain + ATOL
    print(f"scored MCQ logits ({len(examples)} rows, prompt {ids.shape[1]} "
          f"tokens): vs fp32 plain: kernels {err:.3e}, bf16 plain "
          f"{err_plain:.3e} (bound {bound:.3e}); max|logit| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= bound):
        fail(f"scored MCQ logits through the kernels: {err:.3e} from the "
             f"fp32 plain path, above {bound:.3e}")
    cands = {c: runner._letter_token_candidates(tok, c) for c in "ABCD"}
    checked, widest = 0, 0.0
    for lg_k, lg_r in zip(got.cpu().numpy(), ref.cpu().numpy()):
        sk, sr = ({c: runner._logsumexp_ids(lg - runner._logsumexp(lg),
                                            cands[c]) for c in "ABCD"}
                  for lg in (lg_k, lg_r))
        top = sorted(sr.values())
        widest = max(widest, top[-1] - top[-2])
        if top[-1] - top[-2] > 2 * bound:
            checked += 1
            if max(sk, key=sk.get) != max(sr, key=sr.get):
                fail(f"scored MCQ: kernels chose {max(sk, key=sk.get)}, "
                     f"the fp32 plain path {max(sr, key=sr.get)}")
    print(f"scored MCQ letters: {checked} of {len(examples)} rows past the "
          f"margin {2 * bound:.3e} agree with the fp32 plain path (widest "
          f"top-two gap {widest:.3e})", flush=True)


def check_mcq(card, params, cfg):
    """The MCQ benchmark on the bf16 slice's params (module docstring,
    phase 6): the static, scored and engine runners and perplexity."""
    import json as _json
    import math
    import tempfile
    import torch
    from opus_pllm_tpu_torch.evals import datasets as ds
    from opus_pllm_tpu_torch.evals import metric_registry, runner
    from opus_pllm_tpu_torch.infer.scoring import make_logprob_fn
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe

    t_phase = time.perf_counter()
    tok, batch = ByteTokenizer(), 8
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_mcq_test.json")
        with open(path, "w") as f:
            _json.dump(mcq_records(MCQ_REQUESTS), f)
        examples = ds.load_mcq_json(path)
    n = len(examples)
    if n != MCQ_REQUESTS:
        fail(f"load_mcq_json read {n} questions")
    n_batches = -(-n // batch)
    layers, esm_layers = cfg.llm.num_layers, cfg.esm.num_layers
    encoder = {k: esm_layers * n_batches for k in fe.launches}
    quiet = dict(log_fn=lambda *_: None)
    reports = {}
    for label, run in (
            ("generated", lambda: runner.run_mcq_eval(
                params, cfg, tok, path, batch_size=batch,
                examples=examples, **quiet)),
            ("scored", lambda: runner.run_mcq_eval_scored(
                params, cfg, tok, path, batch_size=batch,
                examples=examples, **quiet)),
            ("engine", lambda: runner.run_mcq_eval_engine(
                params, cfg, tok, path, max_slots=SERVE_SLOTS,
                steps_per_tick=SERVE_STEPS, splice_batch=batch,
                examples=examples, **quiet))):
        reset_counts()
        rep = run()
        torch.cuda.synchronize()
        prefills = rep.engine["prefills"] if rep.engine else n_batches
        expect_counts(f"mcq, {label}", read_counts(),
                      flash_attention=layers * prefills, **encoder)
        m = rep.metrics
        if len(rep.results) != n or sum(m["OptionCounts"].values()) != n \
                or not 0.0 <= m["Accuracy"] <= 1.0:
            fail(f"mcq, {label}: {len(rep.results)} results, metrics {m}")
        extra = ""
        if rep.engine:
            extra = (f"; {prefills} prefills, {rep.engine['ticks']} ticks, "
                     f"{rep.decode_tokens} tokens")
        elif rep.decode_tokens:
            extra = (f"; decode {rep.decode_tokens} tokens in "
                     f"{rep.decode_seconds:.2f} s")
        print(f"mcq, {label}: {n} entries in {rep.seconds:.2f} s, entries/s "
              f"{rep.entries_per_sec:.3f}{extra}; Accuracy {m['Accuracy']}, "
              f"OptionCounts {m['OptionCounts']} [{card}]", flush=True)
        reports[label] = rep
    letters = [r["generated"] for r in reports["scored"].results]
    if not all(g in "ABCD"[:len(e.options)]
               for g, e in zip(letters, examples)):
        fail(f"the scored runner's answers are not option letters: "
             f"{letters}")

    render = runner._mcq_renderer(tok, None)
    prompts = [render(ds.mcq_prompt(e.question, e.options))
               for e in examples]
    reset_counts()
    t0 = time.perf_counter()
    ppl = metric_registry.load("perplexity").compute(
        predictions=prompts, logprob_fn=make_logprob_fn(
            params["llm"], cfg.llm, tok.encode,
            bos_token_id=tok.bos_token_id, batch_size=batch))
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    expect_counts("mcq, perplexity", read_counts(),
                  flash_attention=layers * n_batches)
    vals = ppl["perplexities"]
    if len(vals) != n or not all(math.isfinite(v) and v >= 1 for v in vals):
        fail(f"perplexities {vals}")
    print(f"mcq, perplexity over the {n} prompts: mean "
          f"{ppl['mean_perplexity']:.1f}, range {min(vals):.1f}-"
          f"{max(vals):.1f}, {ppl_s:.2f} s [{card}]", flush=True)
    check_mcq_logits(params, cfg, tok, examples[:batch])
    torch.cuda.empty_cache()
    print(f"mcq phase wall {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def _norms_to_fp32(llm):
    """The decoder tree with its embeddings (OPT's learned positions
    included) and norms in fp32; projections (bf16, int8 or int4 leaves)
    stay as they are."""
    small = ("embed_tokens", "embed_positions", "final_norm", "attn_norm",
             "ffn_norm")
    if isinstance(llm, list):
        return [_norms_to_fp32(v) for v in llm]
    if not isinstance(llm, dict):
        return llm
    return {k: ({kk: vv.float() for kk, vv in v.items()} if k in small
                else _norms_to_fp32(v)) for k, v in llm.items()}


def check_decode_step(params, cfg, examples, quantize):
    """One decode step over a prefilled quantized cache: kernels
    (impl="auto", bf16) and plain (impl="torch", bf16) against the plain
    path in fp32 (fp32 activations, embeddings and norms; the same int4
    words and cache bytes)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import decoder, opus
    tok, batch = ByteTokenizer(), 8
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples[:batch]],
        [e.sequence for e in examples[:batch]], prompt_bucket=64,
        esm_bucket=128, device="cuda")
    llm, lcfg = params["llm"], cfg.llm
    with torch.no_grad():
        sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks,
                                left_pad=True)
        pos = decoder.positions_from_mask(sp.mask)
        b, l, _ = sp.embeds.shape
        cap = engine.cache_capacity(lcfg, l, 64)
        cache = decoder.init_cache(lcfg, b, cap, device="cuda",
                                   quantize=quantize)
        cache["mask"][:, :l] = sp.mask
        cols = torch.arange(cap, device="cuda")[None, None, None, :]
        rows = torch.arange(l, device="cuda")[None, None, :, None]
        hid, cache = decoder.forward(
            llm, lcfg, sp.embeds, pos, cache["mask"][:, None, None, :]
            & (cols <= rows), cache, return_hidden=True)
        nxt = decoder.head_logits(llm, lcfg, hid[:, -1]).argmax(-1)
        cache["mask"][:, l] = True
        emb = decoder.embed_tokens(llm, nxt)[:, None]
        step = dict(positions=pos[:, -1:] + 1,
                    mask4=cache["mask"][:, None, None, :])
        out = {}
        for impl in ("auto", "torch"):
            lg, _ = decoder.forward(llm, lcfg, emb, step["positions"],
                                    step["mask4"], _clone(cache), impl=impl)
            out[impl] = lg[:, 0].float()
        lg, _ = decoder.forward(_norms_to_fp32(llm), dataclasses.replace(
            lcfg, dtype="float32"), emb.float(), step["positions"],
            step["mask4"], _clone(cache), impl="torch")
        ref = lg[:, 0]
    err = (out["auto"] - ref).abs().max().item()
    err_plain = (out["torch"] - ref).abs().max().item()
    direct = (out["auto"] - out["torch"]).abs().max().item()
    bound = 2 * err_plain + ATOL
    print(f"decode step ({quantize} cache): |auto - torch| {direct:.3e}; "
          f"vs fp32 plain: auto {err:.3e}, torch {err_plain:.3e} (bound "
          f"{bound:.3e}); max|logit| {ref.abs().max().item():.3e}",
          flush=True)
    if not (torch.isfinite(out["auto"]).all() and err <= bound):
        fail(f"decode step over the {quantize} cache: kernels {err:.3e} "
             f"from the fp32 plain path, bound {bound:.3e}")


def check_quant_slice(card, params, cfg, examples, gen):
    """The bf16 slice's LLM quantized to int4 v2, then the eval with an
    int4 cache (16 requests) and an int8 cache (8)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4

    t0 = time.perf_counter()
    params["llm"] = quant4.quantize_decoder4(params["llm"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"quantize_decoder4 {time.perf_counter() - t0:.1f} s, layout "
          f"{layout}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"weights on the card", flush=True)
    if layout != "int4-v2":
        fail(f"quantized LLM has layout {layout}")
    tok, batch = ByteTokenizer(), 8
    per_step = cfg.llm.num_layers * 7 + 1
    stats = {}
    for kind, n_req in (("int4", 16), ("int8", 8)):
        g = dataclasses.replace(gen, quantize_cache=kind)
        n_batches = -(-n_req // batch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = runner.run_annotation_eval(
            params, cfg, tok, "synthetic_keywords.json", gen=g,
            batch_size=batch, examples=examples[:n_req],
            log_fn=lambda *_: None)
        torch.cuda.synchronize()
        counts = read_counts()
        steps = rep.decode_tokens // batch       # every batch is full here
        expect_counts(
            f"{kind} cache", counts,
            int4_matmul=n_batches + steps * per_step,
            flash_attention=cfg.llm.num_layers * n_batches,
            **{f"decode_attention_{kind}": steps * cfg.llm.num_layers},
            **{n: cfg.esm.num_layers * n_batches for n in fe.launches})
        if len(rep.results) != n_req or not all(
                isinstance(r["generated"], str) for r in rep.results):
            fail(f"{kind} cache: the runner did not answer every request")
        tok_s = rep.decode_tokens / rep.decode_seconds
        ms_step = 1e3 * rep.decode_seconds / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"quantized slice, int4 weights + {kind} cache: "
              f"{len(rep.results)} entries in {rep.seconds:.2f} s, "
              f"entries/s {rep.entries_per_sec:.3f}; decode "
              f"{rep.decode_tokens} tokens in {rep.decode_seconds:.2f} s = "
              f"{tok_s:.1f} tok/s, {ms_step:.2f} ms/step (batch {batch}); "
              f"peak {peak:.2f} GiB on the card [{card}]", flush=True)
        print(f"sample output: {rep.results[0]['generated'][:60]!r}",
              flush=True)
        stats[kind] = counts
        check_decode_step(params, cfg, examples, kind)
    return stats


def check_prefill_group(params, cfg, examples):
    """One admission group's prefill as the serving engine runs it (the
    valid tails of the spliced prompts, zero-padded to one bucket, the
    admission mask, a scratch cache), then the head on each row's last
    position: kernels (impl="auto", bf16: flash_attention and int8_matmul)
    and plain (impl="torch", bf16) against the plain path in fp32 (fp32
    activations, embedding and norms; the same int8 weights)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import decoder, opus
    from opus_pllm_tpu_torch.serve.engine import admission_inputs
    n = len(examples)
    ids, mask, esm_toks = runner._prepare_inputs(
        ByteTokenizer(), [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples],
        [e.sequence for e in examples], prompt_bucket=64, esm_bucket=128,
        device="cuda")
    llm, lcfg = params["llm"], cfg.llm
    with torch.no_grad():
        sp = opus.splice_prompt_left(params, cfg, ids, mask, esm_toks)
        n_valid = sp.mask.sum(1)
        bucket = round_up(int(n_valid.max()), 64)
        embs = torch.zeros((n, bucket, lcfg.hidden_size), dtype=sp.embeds.dtype,
                           device="cuda")
        for r in range(n):
            tail = sp.embeds[r, sp.mask[r]]
            embs[r, :tail.shape[0]] = tail
        pos, mask4 = admission_inputs(n_valid, bucket)
        rows = torch.arange(n, device="cuda")

        def last_logits(tree, c, x, impl):
            cache = decoder.init_cache(c, n, bucket, device="cuda")
            hid, _ = decoder.forward(tree, c, x, pos, mask4, cache,
                                     impl=impl, return_hidden=True)
            h = hid[rows, n_valid - 1][:, None]
            return decoder.head_logits(tree, c, h, impl=impl)[:, 0].float()

        got = last_logits(llm, lcfg, embs, "auto")
        plain = last_logits(llm, lcfg, embs, "torch")
        ref = last_logits(_norms_to_fp32(llm),
                          dataclasses.replace(lcfg, dtype="float32"),
                          embs.float(), "torch")
    err = (got - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    tol = 2 * err_plain + ATOL
    print(f"serving prefill group ({n} rows, bucket {bucket}, M = "
          f"{n * bucket}): vs fp32 plain: kernels {err:.3e}, bf16 plain "
          f"{err_plain:.3e} (tol {tol:.3e}); max|logit| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"serving prefill through the kernels: {err:.3e} from the fp32 "
             f"plain path, above {tol:.3e}")


def check_serve_slice(card, params, cfg, gen):
    """The int8 LLM behind the serving engine: 32 requests with a bf16
    cache, 8 with an int8 cache (module docstring, phase 8)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant, quant4
    from opus_pllm_tpu_torch.models import decoder

    params["llm"] = None                      # the int4 LLM of phase 7
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params["llm"] = quant.quantize_decoder(
        decoder.init(cfg.llm, generator=g, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"init + quantize_decoder {time.perf_counter() - t0:.1f} s, "
          f"layout {layout}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"of weights on the card", flush=True)
    if layout != "int8":
        fail(f"quantized LLM has layout {layout}")
    tok, splice_batch = ByteTokenizer(), 8
    examples = synthetic_examples(SERVE_REQUESTS)
    layers = cfg.llm.num_layers
    stats = {}
    for kind, n_req in ((False, SERVE_REQUESTS), ("int8", 8)):
        label = f"{kind or 'bf16'} cache"
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = runner.run_annotation_eval_engine(
            params, cfg, tok, "synthetic_keywords.json",
            gen=dataclasses.replace(gen, quantize_cache=kind),
            max_slots=SERVE_SLOTS, steps_per_tick=SERVE_STEPS,
            splice_batch=splice_batch, examples=examples[:n_req],
            log_fn=lambda *_: None)
        torch.cuda.synchronize()
        counts = read_counts()
        eng = rep.engine
        prefills, steps = eng["prefills"], eng["decode_steps"]
        want = {n: cfg.esm.num_layers * -(-n_req // splice_batch)
                for n in fe.launches}
        if kind:
            want[f"decode_attention_{kind}"] = layers * steps
        expect_counts(f"serving, {label}", counts,
                      flash_attention=layers * prefills,
                      int8_matmul=7 * layers * prefills, **want)
        if len(rep.results) != n_req or eng["completions"] != n_req \
                or not all(isinstance(r["generated"], str)
                           for r in rep.results):
            fail(f"serving, {label}: not every request was answered")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving slice, int8 weights + {label}: {n_req} entries in "
              f"{rep.seconds:.2f} s, entries/s {rep.entries_per_sec:.3f}; "
              f"{rep.decode_tokens} tokens in {rep.decode_seconds:.2f} s of "
              f"engine time = {rep.decode_tokens / rep.decode_seconds:.1f} "
              f"tok/s; {prefills} prefills, {eng['ticks']} ticks "
              f"({steps} decode steps), {eng['parked']} parked; TTFT p50 <= "
              f"{eng['ttft_p50']} s, p99 <= {eng['ttft_p99']} s, mean "
              f"{eng['ttft_mean']:.3f} s; peak {peak:.2f} GiB on the card "
              f"[{card}]", flush=True)
        print(f"sample output: {rep.results[0]['generated'][:60]!r}",
              flush=True)
        stats[label] = counts
    check_prefill_group(params, cfg, examples[:SERVE_SLOTS])
    return stats["bf16 cache"]


def train_records(n, tok):
    """n synthetic train-lora records: the keywords question followed by
    protein context, sized so that the tokenized prompt is 460-500 tokens,
    a protein of 60-500 residues and a 24-64-token answer (with the
    leading space and EOS), so most records pass the 512-token cap."""
    import numpy as np
    from opus_pllm_tpu_torch.infer.conversation import annotation_prompt
    from opus_pllm_tpu_torch.infer.tokenization import tokenize_with_seq
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    words = ["Membrane", "Transport", "Zinc", "Kinase", "Nucleus",
             "Transmembrane helix", "Hydrolase", "Metal-binding", "Signal"]
    question = "What are the UniProtKB keywords of this protein?"
    context = (" The protein was isolated from a soil bacterium; its gene "
               "lies next to an ABC transporter operon and it is expressed "
               "under zinc limitation.") * 8
    base = len(tokenize_with_seq(annotation_prompt("<seq>\n" + question),
                                 tok.encode, tok.bos_token_id))
    recs = []
    for _ in range(n):
        extra = int(rng.integers(460, 501)) - base
        answer = "; ".join(rng.choice(words, 12))[:int(rng.integers(22, 63))]
        recs.append({"instruction": question + context[:extra],
                     "input": "".join(rng.choice(aa, int(rng.integers(
                         60, 501)))),
                     "output": answer})
    return recs


def _lora_b(trainable):
    return [ab["B"] for lp in trainable["lora"]["layers"]
            for ab in lp.values()]


def run_training(label, card, params, cfg, tcfg, lcfg, batches, want):
    """`fit` over `batches` from fresh LoRA adapters (module docstring,
    phase 11); checks the launch counts against `want` (per step), a finite
    loss every step and every LoRA B leaf moved by step 1. Returns the
    launch counts, the state and its optimizer."""
    import math
    import torch
    from opus_pllm_tpu_torch.core.config import IGNORE_INDEX
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    steps = len(batches)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    state, tx = mmt.create_state(cfg, tcfg, params, generator=g,
                                 train_switch=False, lora_cfg=lcfg,
                                 total_steps=steps, device="cuda")
    b0 = [t.detach().clone() for t in _lora_b(state.trainable)]
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    stamps, losses = [], []

    def log(line):
        stamps.append(time.perf_counter())
        losses.append(float(line.split("loss=")[1]))
        if len(losses) == 1:
            still = sum(bool(torch.equal(a, b)) for a, b in
                        zip(b0, _lora_b(state.trainable)))
            if still:
                fail(f"{label}: {still} LoRA B leaves unchanged by step 1")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = mmt.fit(state, tx, cfg, tcfg, params, batches, lora_cfg=lcfg,
                    log_fn=log, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(f"training, {label}", counts,
                  **{n: steps * c for n, c in want.items()})
    if state.step != steps or len(losses) != steps or not all(
            math.isfinite(x) for x in losses):
        fail(f"{label}: losses {losses} after {state.step} steps")
    walls = [b - a for a, b in zip([t0] + stamps, stamps)]
    per_step = sum(walls[1:]) / (steps - 1)
    tokens = sum(int((b["labels"] != IGNORE_INDEX).sum()) for b in batches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training, {label}: {steps} steps, losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + "; step walls " + ", ".join(f"{w:.3f}" for w in walls)
          + f" s; {per_step:.3f} s/step after the first; "
          f"{tokens / steps / per_step:.1f} trained tokens/s "
          f"({tokens // steps} valid label tokens a step); "
          f"{weights:.2f} GiB on the card with the weights in place, peak "
          f"{peak:.2f} GiB [{card}]", flush=True)
    return counts, state, tx


def _opt_tensors(state):
    """The optimizer's moments and step counters, in leaf order."""
    st = state.opt_state.state_dict()["opt"]["state"]
    return [st[i][k] for i in sorted(st)
            for k in ("step", "exp_avg", "exp_avg_sq")]


def check_checkpoints(card, params, cfg, tcfg, lcfg, state, tx, batches,
                      want):
    """The checkpoint, resume and export gates after the bf16 run (module
    docstring, phase 11): `state` continues over `batches` (the next two of
    the stream) saving every step, then is restored and exported."""
    import tempfile
    import torch
    from opus_pllm_tpu_torch.core import convert
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

    t_phase = time.perf_counter()
    start = state.step
    last = start + len(batches)

    def fresh():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 1)
        return mmt.create_state(cfg, tcfg, params, generator=g,
                                train_switch=False, lora_cfg=lcfg,
                                total_steps=start, device="cuda")[0]

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "resume_state"),
                                max_to_keep=2)
        reset_counts()
        t0 = time.perf_counter()
        state = mmt.fit(state, tx, cfg, tcfg, params, batches, lora_cfg=lcfg,
                        log_fn=lambda *_: None, device="cuda", ckpt=mgr,
                        save_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        expect_counts("training, checkpointed steps", read_counts(),
                      **{n: len(batches) * c for n, c in want.items()})
        kept = mgr.all_steps()
        print(f"checkpointed steps {start + 1}-{last}: {fit_s:.2f} s with a "
              f"save every step; latest {mgr.latest_step()}, kept {kept}",
              flush=True)
        if mgr.latest_step() != last or kept != [last - 1, last]:
            fail(f"checkpoints: latest {mgr.latest_step()}, kept {kept}")
        t0 = time.perf_counter()
        back = mmt.restore_state(mgr, fresh())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = [torch.equal(a, b) for a, b in
                zip(mmt.leaves(back.trainable) + _opt_tensors(back),
                    mmt.leaves(state.trainable) + _opt_tensors(state))]
        if back.step != last or not all(same) or \
                back.opt_state.count != state.opt_state.count:
            fail(f"restored step {back.step}: {same.count(False)} of "
                 f"{len(same)} tensors differ from the state in memory")
        print(f"restore_state at step {last} ({restore_s:.2f} s): the LoRA "
              f"leaves, both moments and the step equal the state in "
              f"memory bit for bit ({len(same)} tensors)", flush=True)
        del back
        resumed = mmt.restore_state(mgr, fresh(), step=last - 1)
        resumed = mmt.fit(resumed, resumed.opt_state, cfg, tcfg, params,
                          batches[-1:], lora_cfg=lcfg,
                          log_fn=lambda *_: None, device="cuda")
        torch.cuda.synchronize()
        pairs = list(zip(mmt.leaves(resumed.trainable),
                         mmt.leaves(state.trainable)))
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in pairs)
        n_equal = sum(torch.equal(a, b) for a, b in pairs)
        print(f"step {last} again from the step-{last - 1} checkpoint: "
              f"{n_equal} of {len(pairs)} LoRA leaves bit-identical, max "
              f"difference {rel:.3e} of a leaf's largest entry", flush=True)
        if resumed.step != last or not rel <= 1e-6:
            fail(f"resumed step {last} is {rel:.3e} from the one in memory")
        del resumed

        t0 = time.perf_counter()
        sd = convert.lora_to_peft(state.trainable["lora"], family="llama")
        path = os.path.join(tmp, "adapter_model.bin")
        convert.save_torch_state_dict(sd, path)
        loaded = torch.load(path, weights_only=True)
        n_proj = len(lcfg.target_modules)
        bad = [k for k, v in sd.items()
               if not torch.equal(loaded[k], torch.from_numpy(v))]
        shapes_ok = all(
            sd[f"{stem}.lora_A.weight"].shape == tuple(ab["A"].shape[::-1])
            and sd[f"{stem}.lora_B.weight"].shape
            == tuple(ab["B"].shape[::-1])
            for i, lp in enumerate(state.trainable["lora"]["layers"])
            for proj, ab in lp.items()
            for stem in [f"base_model.model.model.layers.{i}."
                         f"{'self_attn' if proj[0] in 'qkvo' else 'mlp'}."
                         f"{proj}"])
        print(f"export: lora_to_peft gives {len(sd)} keys, "
              f"save_torch_state_dict + torch.load in "
              f"{time.perf_counter() - t0:.2f} s, {len(bad)} tensors "
              f"differ", flush=True)
        if len(sd) != cfg.llm.num_layers * n_proj * 2 or bad or \
                list(loaded) != list(sd) or not shapes_ok:
            fail(f"export: {len(sd)} keys, {len(bad)} differ after "
                 f"torch.load, (out, in) shapes {shapes_ok}")
        if "switch" in state.trainable:
            convert.save_torch_state_dict(
                convert.switch_projector_to_torch(state.trainable["switch"]),
                os.path.join(tmp, "modality_refinement_projection.bin"))
        mgr.close()
    print(f"checkpoint gates wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def _gate_grads(trainable, frozen, cfg, batch, ls, tcfg, impl):
    import torch
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    tr = {"lora": mmt._trainable_copy(trainable["lora"])}
    loss, _ = mmt.loss_fn(tr, frozen, cfg, batch, ls, tcfg.remat_mode,
                          tcfg.ce_chunk, impl)
    return [t.float() for t in torch.autograd.grad(loss, mmt.leaves(tr))]


def gradient_gate(params, cfg, tcfg, lcfg, batch):
    """The LoRA gradients of loss_fn through the kernels vs the plain path
    in fp32 (module docstring, phase 11), at depth GATE_LAYERS."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.lora import lora as lora_mod
    from opus_pllm_tpu_torch.models import esm2
    llm = dict(params["llm"], layers=params["llm"]["layers"][:GATE_LAYERS])
    cfg4 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=GATE_LAYERS))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    lora = lora_mod.init(cfg4.llm, lcfg, generator=g, device="cuda")
    for lp in lora["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.01, generator=g)
    rows = {k: torch.as_tensor(v[:GATE_ROWS]).cuda() for k, v in batch.items()
            if k != "esm_tokens"}
    with torch.no_grad():
        esm = torch.as_tensor(batch["esm_tokens"][:GATE_ROWS]).cuda()
        rows["pooled_emb"] = esm2.pooled_embedding(
            params["esm"], cfg.esm, esm[:, 0]).float()[:, None]
    ls = lora_mod.scaling(lcfg)
    frozen = dict(params, llm=llm)
    got = _gate_grads({"lora": lora}, frozen, cfg4, rows, ls, tcfg, "auto")
    plain = _gate_grads({"lora": lora}, frozen, cfg4, rows, ls, tcfg, "torch")
    cfg32 = dataclasses.replace(cfg4, llm=dataclasses.replace(
        cfg4.llm, dtype="float32"))
    ref = _gate_grads({"lora": lora}, dict(params, llm=_to_fp32(llm)), cfg32,
                      rows, ls, tcfg, "torch")
    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
    err = max(rel(a, r) for a, r in zip(got, ref))
    err_plain = max(rel(a, r) for a, r in zip(plain, ref))
    bound = 2 * err_plain + ATOL
    print(f"gradient gate ({GATE_LAYERS} layers, {GATE_ROWS} rows of "
          f"{rows['input_ids'].shape[1]} prompt tokens, {len(ref)} LoRA "
          f"leaves), "
          f"max error in units of each leaf's largest entry vs fp32 plain: "
          f"kernels {err:.3e}, bf16 plain {err_plain:.3e} (bound "
          f"{bound:.3e})", flush=True)
    if not (all(torch.isfinite(a).all() for a in got) and err <= bound):
        fail(f"gradient gate: kernels {err:.3e} from the fp32 plain path, "
             f"above {bound:.3e}")


def check_train_slice(card, params, cfg):
    """Phase 11 (module docstring): `train-lora` over the bf16 LLM, the
    gradient gate, then QLoRA over its v1 quantization."""
    import itertools
    import json as _json
    import tempfile
    import torch
    from opus_pllm_tpu_torch.core.config import LoRAConfig, TrainConfig
    from opus_pllm_tpu_torch.data.collate import instruction_batches
    from opus_pllm_tpu_torch.data.datasets import InstructionDataset
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import decoder

    params["llm"] = None                      # the int8 LLM of phase 8
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params["llm"] = decoder.init(cfg.llm, generator=g, device="cuda")
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.1f} s", flush=True)
    tok = ByteTokenizer()
    tcfg = TrainConfig(learning_rate=2e-5, weight_decay=0.0,
                       batch_size=TRAIN_BATCH, remat="full", ce_chunk=0,
                       grad_accum=1, log_every=1)
    lcfg = LoRAConfig(rank=16, alpha=32.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.json")
        with open(path, "w") as f:
            _json.dump(train_records(TRAIN_RECORDS, tok), f)
        # a second epoch of the records gives the checkpointed steps
        batches = list(itertools.islice(instruction_batches(
            InstructionDataset(path), tok, TRAIN_BATCH, seed=SEED, epochs=2,
            max_len=TRAIN_MAX_LEN), TRAIN_STEPS_BF16 + TRAIN_STEPS_CKPT))
    lengths = {b["input_ids"].shape[1] + cfg.switch.n_tokens - 1
               for b in batches}
    if lengths != {TRAIN_LEN}:
        fail(f"training batches reach decoder lengths {lengths}, not "
             f"{TRAIN_LEN}")
    layers = cfg.llm.num_layers
    base = {"flash_attention": 2 * layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            **{n: cfg.esm.num_layers for n in fe.launches}}
    counts, state, tx = run_training("bf16 LLM", card, params, cfg, tcfg,
                                     lcfg, batches[:TRAIN_STEPS_BF16], base)
    check_checkpoints(card, params, cfg, tcfg, lcfg, state, tx,
                      batches[TRAIN_STEPS_BF16:], base)
    del state, tx
    torch.cuda.empty_cache()
    gradient_gate(params, cfg, tcfg, lcfg, batches[0])

    t0 = time.perf_counter()
    params["llm"] = quant4.quantize_decoder4(params["llm"], layout="v1")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"quantize_decoder4(layout='v1') {time.perf_counter() - t0:.1f} s, "
          f"layout {layout}", flush=True)
    if layout != "int4-v1" or any(
            p.dtype != torch.int8 for p in
            [params["llm"]["lm_head"]["kernel_p"]]
            + [lp[t]["kernel_p"] for lp in params["llm"]["layers"]
               for t in lcfg.target_modules]):
        fail(f"the QLoRA LLM is not v1 everywhere ({layout})")
    qcounts = run_training(
        "int4-v1 LLM (QLoRA)", card, params, cfg, tcfg, lcfg,
        batches[:TRAIN_STEPS_QLORA],
        dict(base, int4_matmul_v1=2 * 7 * layers + 1))[0]
    return counts, qcounts


def uniprot_records(n):
    """n synthetic UniProt records drawn from SEED: unique proteins of
    60-500 residues, and a Similarity field sized so that the caption
    `uniprot_text` renders is 200-TEXT_LEN ByteTokenizer tokens."""
    import numpy as np
    from opus_pllm_tpu_torch.data.datasets import uniprot_text
    rng = np.random.default_rng(SEED + 1)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    words = ("belongs", "to", "the", "protein", "kinase", "superfamily",
             "domain", "binds", "zinc", "transporter", "subunit", "family",
             "catalytic", "membrane", "ribosomal", "ligase")
    recs, seen = {}, set()
    while len(recs) < n:
        seq = "".join(rng.choice(aa, int(rng.integers(60, 501))))
        if seq in seen:
            continue
        seen.add(seq)
        acc = f"Q{len(recs):05d}"
        rec = {"Sequence": seq, "Name": [f"Protein {len(recs)}"],
               "Accession": [acc], "Similarity": "",
               "Subcellular_Location": "Cytoplasm"}
        want = int(rng.integers(200, TEXT_LEN + 1)) - len(uniprot_text(rec))
        filler = " ".join(rng.choice(words, want // 4 + 1))
        rec["Similarity"] = filler[:want]
        recs[acc] = rec
    return recs


def _vs_fp32(label, got, plain, ref):
    """Kernels (`got`) and the plain path in bf16 (`plain`) against the
    plain path in fp32 (`ref`), with phase 3's bound."""
    import torch
    err = (got.float() - ref).abs().max().item()
    err_plain = (plain.float() - ref).abs().max().item()
    bound = 2 * err_plain + ATOL
    print(f"{label}: kernels vs fp32 plain {err:.3e}, bf16 plain vs fp32 "
          f"plain {err_plain:.3e} (bound {bound:.3e}); max|ref| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= bound):
        fail(f"{label}: kernels {err:.3e} from the fp32 plain path, above "
             f"{bound:.3e}")


def _caption_batch(tok, texts, bucket=128):
    """precompute_cstp_pairs' text batch: right-padded to the bucket."""
    import numpy as np
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    enc = [tok.encode(t) for t in texts]
    pad_to = round_up(max(len(e) for e in enc), bucket)
    ids = np.full((len(enc), pad_to), tok.pad_token_id, np.int32)
    mask = np.zeros((len(enc), pad_to), bool)
    for i, e in enumerate(enc):
        ids[i, :len(e)] = e
        mask[i, :len(e)] = True
    return torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()


def check_text_embeddings(label, llm, lcfg, ids, mask):
    """One text batch's `text_embeddings` (mask_pad=False) through the
    kernels (impl="auto", bf16) and plain (bf16) against the plain path in
    fp32 (fp32 activations, embeddings and norms; the same bf16
    projections)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.models import text_encoder
    with torch.no_grad():
        got = text_encoder.text_embeddings(llm, lcfg, ids, mask, impl="auto")
        plain = text_encoder.text_embeddings(llm, lcfg, ids, mask,
                                             impl="torch")
        ref = text_encoder.text_embeddings(
            _norms_to_fp32(llm), dataclasses.replace(lcfg, dtype="float32"),
            ids, mask, impl="torch")
    if got.shape != (ids.shape[0], lcfg.hidden_size):
        fail(f"{label}: text embeddings of shape {tuple(got.shape)}")
    _vs_fp32(f"{label} text_embeddings ({ids.shape[0]} x {ids.shape[1]})",
             got, plain, ref)


def check_esm_batch(label, esm, seqs):
    """One ESM2 batch's pooled embedding through the kernels against the
    plain layer composition in fp32 (as phase 4)."""
    import torch
    from opus_pllm_tpu_torch.core.config import ESM2Config
    from opus_pllm_tpu_torch.models import esm2
    toks, _ = esm2.tokenize(seqs)
    toks = torch.from_numpy(toks).cuda()
    with torch.no_grad():
        got = esm2.pooled_embedding(esm, ESM2Config(dtype="bfloat16"), toks,
                                    impl="auto")
        plain = esm2.pooled_embedding(esm, ESM2Config(dtype="bfloat16"),
                                      toks, impl="torch")
        ref = esm2.pooled_embedding(_to_fp32(esm), ESM2Config(), toks,
                                    impl="torch")
    _vs_fp32(f"{label} esm2 pooled ({len(seqs)} proteins)", got, plain, ref)


def evidential_fp64(p2t, t2p, cfg):
    """losses.trust_evidence written out in fp64 on the same (B, B)
    similarities: (the loss, the bound on its fp32 evaluation's rounding
    error). The bound is 8 units of fp32 rounding (2^-24: one for each
    level of a 128-term sum's pairwise reduction and one for the lgamma
    or digamma itself) times the summed magnitudes of the terms that the
    evidential CE and the Dirichlet KL add and subtract (the lgamma and
    digamma terms, and the evidence itself for the rounding of logits /
    T), meaned over the rows and both directions as the loss is."""
    import math
    import torch
    import torch.nn.functional as tnf
    coef = (min(cfg.kl_coefficient, (cfg.evidence_global_step
                                     - cfg.kl_threshold_step + 1)
                / cfg.kl_annealing_steps)
            if cfg.evidence_global_step >= cfg.kl_threshold_step else 0.0)

    def direction(logits):
        x = logits.double() / cfg.temperature
        c = x.shape[-1]
        alpha = tnf.elu(x) + 1.0 + 1.0                    # W / c = 1
        s = alpha.sum(-1)
        label = torch.eye(c, dtype=torch.float64, device=x.device)
        a_t = (alpha * label).sum(-1)
        ce = torch.digamma(s) - torch.digamma(a_t)
        alp = (alpha - 1.0) * (1.0 - label) + 1.0
        s2 = alp.sum(-1)
        lg = torch.lgamma(alp)
        dg = torch.digamma(alp) - torch.digamma(s2)[:, None]
        kl = (torch.lgamma(s2) - lg.sum(-1) - math.lgamma(c)
              + ((alp - 1.0) * dg).sum(-1))
        mag = (torch.digamma(s).abs() + torch.digamma(a_t).abs()
               + coef * (torch.lgamma(s2).abs() + lg.abs().sum(-1)
                         + math.lgamma(c)
                         + ((alp - 1.0).abs()
                            * (torch.digamma(alp).abs()
                               + torch.digamma(s2).abs()[:, None])).sum(-1))
               + 2.0 * alpha.sum(-1))
        return float((ce + coef * kl).mean()), float(mag.mean())

    (lp, mp), (lt, mt) = direction(p2t), direction(t2p)
    return 0.5 * (lp + lt), 8.0 * 2.0 ** -24 * 0.5 * (mp + mt)


def evidential_witness(params, cfg, pair, card):
    """One batch's evidential loss through losses.trust_evidence (fp32)
    beside evidential_fp64 on the same similarities; fails unless they
    agree within its bound. Prints the scaled similarities' range and the
    share of live evidence (elu + 1 >= 1e-3)."""
    import torch
    from opus_pllm_tpu_torch.bridge import cstp, losses
    with torch.no_grad():
        al = cstp.alignment(*cstp.forward(params, *(
            torch.as_tensor(a, device="cuda") for a in pair)))
        p2t, t2p = al["protein2text"], al["text2protein"]
        got = float(losses.trust_evidence(p2t, t2p, al["targets"], cfg))
        x = p2t / cfg.temperature
        live = float((torch.nn.functional.elu(x) + 1.0 >= 1e-3)
                     .float().mean())
    ref, bound = evidential_fp64(p2t, t2p, cfg)
    print(f"  evidential loss on the step's similarities: fp32 {got:.6g}, "
          f"fp64 {ref:.6g} (|diff| {abs(got - ref):.4g}, fp32 bound "
          f"{bound:.4g}); logits / T in [{float(x.min()):.4g}, "
          f"{float(x.max()):.4g}], live evidence {live:.4f} [{card}]",
          flush=True)
    if not abs(got - ref) <= bound:
        fail(f"evidential loss fp32 {got} against fp64 {ref}: outside "
             f"fp32's rounding bound {bound}")


def check_stage_a(card, params):
    """Phase 12 (module docstring): precompute-pairs over ESM2-650M and a
    Llama-3-8B text LM, then train-cstp with its checkpoints and the
    automatic InfoNCE warm-up."""
    import dataclasses
    import math
    import pickle
    import tempfile
    import torch
    from opus_pllm_tpu_torch.bridge import cstp, losses
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.core.config import (CSTPConfig, DecoderConfig,
                                                 ESM2Config, TrainConfig)
    from opus_pllm_tpu_torch.data import precompute
    from opus_pllm_tpu_torch.data.datasets import (UniProtQAVecDataset,
                                                   batch_iterator,
                                                   uniprot_text)
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import decoder
    from opus_pllm_tpu_torch.train import cstp_trainer as ct

    t_phase = time.perf_counter()
    params["llm"] = None                      # the QLoRA LLM of phase 11
    torch.cuda.empty_cache()
    lcfg, ecfg = DecoderConfig.llama3_8b(), ESM2Config(dtype="bfloat16")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    llm = decoder.init(lcfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    print(f"text LM (Llama-3-8B bf16) drawn: "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    tok = ByteTokenizer()
    recs = uniprot_records(STAGE_A_RECORDS)
    lens = [len(tok.encode(uniprot_text(r))) for r in recs.values()]
    print(f"{len(recs)} records: proteins "
          f"{min(len(r['Sequence']) for r in recs.values())}-"
          f"{max(len(r['Sequence']) for r in recs.values())} residues, "
          f"captions {min(lens)}-{max(lens)} tokens", flush=True)
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        up, out = os.path.join(tmp, "uniprot.pkl"), os.path.join(tmp, "p.pkl")
        with open(up, "wb") as f:
            pickle.dump(recs, f)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        n = precompute.precompute_cstp_pairs(params["esm"], ecfg, llm, lcfg,
                                             tok, up, out, stats=stats)
        counts = read_counts()
        se, te = UniProtQAVecDataset(out).arrays()
    # precompute's batches of 8: the unique sequences, then the records
    esm_batches = -(-len({r["Sequence"] for r in recs.values()}) // 8)
    text_batches = -(-len(recs) // 8)
    expect_counts("stage (a) precompute", counts,
                  flash_attention=lcfg.num_layers * text_batches,
                  **{k: ecfg.num_layers * esm_batches for k in fe.launches})
    dims = (ecfg.embed_dim, lcfg.hidden_size)
    if (n, se.shape, te.shape) != (STAGE_A_RECORDS, (n, dims[0]),
                                   (n, dims[1])) \
            or se.dtype != te.dtype or se.dtype.name != "float32" or not (
            math.isfinite(float(se.sum())) and math.isfinite(float(te.sum()))):
        fail(f"precompute wrote {n} pairs of {se.shape} {se.dtype} / "
             f"{te.shape} {te.dtype}, not {STAGE_A_RECORDS} finite fp32 "
             f"pairs of {dims[0]} / {dims[1]}")
    print(f"precompute-pairs: {n} pairs; ESM2 {esm_batches} "
          f"batches in {stats['esm_seconds']:.2f} s "
          f"({n / stats['esm_seconds']:.1f} proteins/s), text "
          f"{text_batches} batches in {stats['text_seconds']:.2f} "
          f"s ({n / stats['text_seconds']:.2f} captions/s), "
          f"{n / (stats['esm_seconds'] + stats['text_seconds']):.2f} "
          f"pairs/s; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB [{card}]", flush=True)
    # the text half's dense products: 2 FLOP a layer weight a padded token
    # (precompute's batches of 8 in record order, 128-token buckets)
    padded = sum(8 * -(-max(lens[i:i + 8]) // 128) * 128
                 for i in range(0, len(lens), 8))
    layer_w = sum(t.numel() for lp in llm["layers"] for p in lp.values()
                  for t in p.values())
    print(f"text LM: {padded} padded tokens ({sum(lens)} valid), dense "
          f"products {2 * layer_w * padded / stats['text_seconds'] / 1e12:.1f}"
          f" TFLOP/s over the text half [{card}]", flush=True)
    items = list(recs.values())
    ids, mask = _caption_batch(tok, [uniprot_text(r) for r in items[:8]])
    check_text_embeddings("stage (a)", llm, lcfg, ids, mask)
    check_esm_batch("stage (a)", params["esm"],
                    [r["Sequence"] for r in items[:8]])
    del llm, ids, mask
    torch.cuda.empty_cache()

    # train-cstp's defaults; the text dim is the text LM's hidden size
    ccfg = CSTPConfig(protein_dim=dims[0], text_dim=dims[1], proj_dim=5120)
    tcfg = TrainConfig(learning_rate=0.05, weight_decay=1e-4,
                       batch_size=128, num_epochs=STAGE_A_EPOCHS)
    tr_se, tr_te = se[:STAGE_A_TRAIN], te[:STAGE_A_TRAIN]
    stream = [(tr_se[i], tr_te[i]) for i in batch_iterator(
        STAGE_A_TRAIN, tcfg.batch_size, seed=SEED,
        epochs=STAGE_A_EPOCHS + 2)]
    n_steps = STAGE_A_TRAIN // tcfg.batch_size * STAGE_A_EPOCHS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    state, tx = ct.create_state(ccfg, tcfg, generator=gen, device="cuda")
    seen, stamps = [], []

    def record(step_no, m):
        m = {k: float(v) for k, v in m.items()}
        stamps.append(time.perf_counter())
        seen.append(m)
        print(f"  step {step_no}: " + " ".join(
            f"{k}={v:.4g}" for k, v in m.items()), flush=True)
        if not (math.isfinite(m["loss"])
                and 0.0 <= m["acc_seq2text"] <= 1.0
                and 0.0 <= m["acc_text2seq"] <= 1.0):
            fail(f"train-cstp step {step_no}: {m}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ct.fit(state, tx, ccfg, tcfg, stream[:n_steps],
                   log_fn=lambda *_: None, metrics_fn=record)
    steps = [b - a for a, b in zip([t0] + stamps, stamps)]
    dead = sum(m["evidence_dead"] for m in seen)
    val = ct.evaluate(state.params, ccfg, [(se[STAGE_A_TRAIN:],
                                            te[STAGE_A_TRAIN:])])
    if not (math.isfinite(val["loss"]) and 0.0 <= val["acc_seq2text"] <= 1.0
            and 0.0 <= val["acc_text2seq"] <= 1.0):
        fail(f"evaluate on the held-out {n - STAGE_A_TRAIN}: {val}")
    print(f"train-cstp: {n_steps} steps of {tcfg.batch_size} pairs, "
          f"{sum(steps[1:]) / max(len(steps) - 1, 1) * 1e3:.2f} ms/step "
          f"after the first ({steps[0] * 1e3:.1f} ms); evidence dead on "
          f"{dead:.0f} of {n_steps} steps; held-out {n - STAGE_A_TRAIN}: "
          + " ".join(f"{k}={v:.4g}" for k, v in val.items())
          + f" [{card}]", flush=True)

    # the checkpoint gates: 2 more steps saving every step, then restore
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, max_to_keep=2)
        state = ct.fit(state, tx, ccfg, tcfg, stream[n_steps:n_steps + 2],
                       log_fn=lambda *_: None, metrics_fn=record, ckpt=mgr,
                       save_every=1)
        fresh, _ = ct.create_state(ccfg, tcfg, generator=gen, device="cuda")
        back = ct.restore_state(mgr, fresh)
        kept = mgr.all_steps()
    same = [bool(torch.equal(a, b)) for a, b in zip(
        ct.leaves(back.params) + _opt_tensors(back),
        ct.leaves(state.params) + _opt_tensors(state))]
    if kept != [n_steps + 1, n_steps + 2] or back.step != state.step \
            or back.opt_state.count != tx.count or not all(same):
        fail(f"train-cstp checkpoint: kept {kept}, restored step "
             f"{back.step} of {state.step}, {sum(same)} of {len(same)} "
             f"tensors equal")
    print(f"train-cstp checkpoints: steps {kept} kept, restore_state of "
          f"step {back.step} equal bit for bit ({len(same)} tensors)",
          flush=True)
    del back, fresh

    # the automatic InfoNCE warm-up from the same state, a step a call:
    # before each, the evidential loss on the step's own similarities
    auto = dataclasses.replace(ccfg, warmup_info_nce_steps=-1)
    seen.clear()
    for pair in stream[n_steps + 2:n_steps + 4]:
        evidential_witness(state.params, auto, pair, card)
        state = ct.fit(state, tx, auto, tcfg, [pair],
                       log_fn=lambda *_: None, metrics_fn=record)
    if len(seen) != 2 or not all(m["grad_norm"] > 0 for m in seen):
        fail(f"auto warm-up steps with a zero gradient: {seen}")
    print(f"auto warm-up: {len(seen)} steps, InfoNCE on "
          f"{sum(m['warmup_active'] for m in seen):.0f}, gradient norms "
          + ", ".join(f"{m['grad_norm']:.4g}" for m in seen), flush=True)
    print(f"stage (a) phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def check_families(card, params, cfg):
    """Phase 13 (module docstring): Qwen2.5-7B and Galactica-6.7B, each
    drawn in bf16 from SEED, answer keywords requests and give text
    embeddings through the kernels."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.bridge import projector
    from opus_pllm_tpu_torch.core.config import (DecoderConfig,
                                                 GenerationConfig)
    from opus_pllm_tpu_torch.data.datasets import uniprot_text
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import decoder, opus, text_encoder

    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    examples = synthetic_examples(FAMILY_REQUESTS)
    gen = GenerationConfig(max_new_tokens=32, temperature=0.1, top_p=0.7,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=SEED)
    captions = [uniprot_text(r) for r in
                list(uniprot_records(FAMILY_REQUESTS).values())]
    for name, lcfg in (("Qwen2.5-7B", DecoderConfig.qwen25_7b()),
                       ("Galactica-6.7B", DecoderConfig.galactica_6_7b())):
        params["llm"] = params["switch"] = None
        torch.cuda.empty_cache()
        fcfg = dataclasses.replace(cfg, llm=lcfg, switch=dataclasses.replace(
            cfg.switch, llm_hidden_size=lcfg.hidden_size))
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED)
        params["llm"] = decoder.init(lcfg, generator=g, device="cuda")
        params["switch"] = projector.init(fcfg.switch, generator=g,
                                          device="cuda")
        torch.cuda.synchronize()
        gib = torch.cuda.memory_allocated() / 2**30
        reset_counts()
        rep = runner.run_annotation_eval(
            params, fcfg, tok, "synthetic_keywords.json", gen=gen,
            batch_size=FAMILY_REQUESTS, examples=examples,
            log_fn=lambda *_: None)
        counts = read_counts()
        expect_counts(f"{name} annotate", counts,
                      flash_attention=lcfg.num_layers,
                      **{k: cfg.esm.num_layers for k in fe.launches})
        if len(rep.results) != len(examples) or not all(
                isinstance(r["generated"], str) for r in rep.results):
            fail(f"{name}: not every request was answered")
        ids, mask = _caption_batch(tok, captions)
        reset_counts()
        with torch.no_grad():
            emb = text_encoder.text_embeddings(params["llm"], lcfg, ids,
                                               mask)
        torch.cuda.synchronize()
        tcounts = read_counts()
        expect_counts(f"{name} text_embeddings", tcounts,
                      flash_attention=lcfg.num_layers)
        if emb.shape != (len(captions), lcfg.hidden_size) or not bool(
                torch.isfinite(emb).all()):
            fail(f"{name}: text embeddings {tuple(emb.shape)} not finite")
        tok_s = rep.decode_tokens / rep.decode_seconds
        print(f"{name}: {len(rep.results)} entries in {rep.seconds:.2f} s, "
              f"entries/s {rep.entries_per_sec:.3f}; decode "
              f"{rep.decode_tokens} tokens in {rep.decode_seconds:.2f} s = "
              f"{tok_s:.1f} tok/s (batch {FAMILY_REQUESTS}); {gib:.1f} GiB "
              f"on the card; sample {rep.results[0]['generated'][:40]!r} "
              f"[{card}]", flush=True)

        # one prefill's logits: the same spliced embeddings through the
        # decoder's kernels, its plain path in bf16, and in fp32
        pids, pmask, esm_toks = runner._prepare_inputs(
            tok, [runner.annotation_prompt(runner.ds.instruction_for(
                e, "synthetic_keywords.json")) for e in examples],
            [e.sequence for e in examples], prompt_bucket=64,
            esm_bucket=128, device="cuda")
        llm = params["llm"]
        with torch.no_grad():
            sp = opus.splice_prompt(params, fcfg, pids, pmask, esm_toks,
                                    left_pad=True)
            pos = decoder.positions_from_mask(sp.mask)
            m4 = decoder.layers.causal_mask(sp.mask)
            lg = {}
            for impl in ("auto", "torch"):
                hid, _ = decoder.forward(llm, lcfg, sp.embeds, pos, m4,
                                         impl=impl, return_hidden=True)
                lg[impl] = decoder.head_logits(llm, lcfg, hid[:, -1])
            hid, _ = decoder.forward(
                _norms_to_fp32(llm), dataclasses.replace(lcfg,
                                                         dtype="float32"),
                sp.embeds.float(), pos, m4, impl="torch", return_hidden=True)
            ref = decoder.head_logits(_norms_to_fp32(llm), dataclasses.replace(
                lcfg, dtype="float32"), hid[:, -1])
        _vs_fp32(f"{name} prefill logits ({sp.embeds.shape[0]} x "
                 f"{sp.embeds.shape[1]})", lg["auto"], lg["torch"], ref)
        check_text_embeddings(name, llm, lcfg, ids, mask)
        del sp, hid, lg, ref, llm
    params["llm"] = params["switch"] = None
    torch.cuda.empty_cache()
    print(f"families phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def option_flash_cases():
    """phase 3's flash shapes on the serving options' paths, masks drawn
    from their own generator (SEED + 3): (generator, ((label, B, Sq, Skv,
    mask), ...)). Each mask gives every query row a valid key."""
    import torch
    from opus_pllm_tpu_torch.serve.engine import (admission_inputs,
                                                  chunk_inputs, verify_mask)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    # the verify pass: 17 rows (16 slots and the spare), K = 4 chunk rows
    # over a 1024-slot cache, lengths spread over 64-960
    lengths = torch.randint(64, 961, (SERVER_SLOTS + 1,), generator=g,
                            device="cuda")
    verify = verify_mask(lengths, SPEC_K, CHUNK_CAP)
    # a chunk step: 4 rows at offsets 0 / 256 / 512 / 768, full chunks
    off = torch.arange(4, device="cuda") * CHUNK
    _, chunk = chunk_inputs(torch.full((4,), CHUNK, device="cuda"), off,
                            CHUNK, CHUNK_CAP)
    # a prefix merge: 8 suffixes of 64-128 tokens after a 64-token prefix
    n_sfx = torch.randint(64, 129, (8,), generator=g, device="cuda")
    _, merge = admission_inputs(n_sfx, 128, 64)
    cases = ((f"verify B={SERVER_SLOTS + 1} Sq={SPEC_K} Skv={CHUNK_CAP}",
              SERVER_SLOTS + 1, SPEC_K, CHUNK_CAP, verify),
             (f"chunk B=4 Sq={CHUNK} Skv={CHUNK_CAP} offsets 0-768", 4,
              CHUNK, CHUNK_CAP, chunk),
             ("prefix merge B=8 Sq=128 Skv=64+128", 8, 128, 192, merge))
    for label, *_, mask in cases:
        if not bool(mask.any(-1).all()):
            fail(f"flash {label}: a query row has no valid key")
    return g, cases


def random_adapter(lcfg, g):
    """A rank-16 adapter on the seven projections (LoRAConfig's defaults:
    alpha 32), B drawn from N(0, 0.02) so that it acts, folded by
    fold_scaling for a bank at lora_scale 1."""
    from opus_pllm_tpu_torch.core.config import LoRAConfig
    from opus_pllm_tpu_torch.lora import lora
    lc = LoRAConfig()
    t = lora.init(lcfg, lc, generator=g, device="cuda")
    for lp in t["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.02, generator=g)
    return lora.fold_scaling(t, lora.scaling(lc))


def keyword_tails(params, cfg, tok, examples, plen=0):
    """The engine runner's prompts for keywords requests, spliced (each
    row's valid tail on the card), the first `plen` tokens cut off."""
    from opus_pllm_tpu_torch.evals import runner
    ids = [runner.tokenize_with_seq(
        runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")), tok.encode,
        tok.bos_token_id)[plen:] for e in examples]
    return runner.splice_tails(params, cfg, tok, ids,
                               [e.sequence for e in examples],
                               splice_batch=8, prompt_bucket=64,
                               esm_bucket=128), ids


def group_embs(tails, bucket):
    """Valid tails -> (embs (n, bucket, H) zero-padded, n_valid (n,))."""
    import torch
    n_valid = torch.tensor([t.shape[0] for t in tails], device="cuda")
    embs = torch.zeros((len(tails), bucket, tails[0].shape[1]),
                       dtype=tails[0].dtype, device="cuda")
    for r, t in enumerate(tails):
        embs[r, :t.shape[0]] = t
    return embs, n_valid


def gate(label, got, plain, ref):
    """Outputs through the kernels against the fp32 plain path, within 2 x
    the plain bf16 path's error + ATOL (phase 3's bound)."""
    import torch
    err = (got - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    tol = 2 * err_plain + ATOL
    print(f"{label}: vs fp32 plain: kernels {err:.3e}, bf16 plain "
          f"{err_plain:.3e} (tol {tol:.3e}); max|ref| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        fail(f"{label}: {err:.3e} from the fp32 plain path, above {tol:.3e}")
    return tol


def teacher_forced(label, llm, lcfg, tails, outs, cap, tol):
    """Each request's prompt and emitted tokens through one causal
    prefill through the kernels: every emitted greedy token must be the
    argmax there, or within `tol` of it (two bf16 paths, each within the
    logit bound of the fp32 one, may order a near-tie apart). Prints the
    argmax hits and the largest gap."""
    import torch
    from opus_pllm_tpu_torch.models import decoder
    hits = total = 0
    worst = 0.0
    with torch.no_grad():
        for t, toks in zip(tails, outs):
            ids = torch.tensor(toks, device="cuda")
            x = torch.cat([t, decoder.embed_tokens(llm, ids[:-1]).to(
                t.dtype)])[None]
            ar = torch.arange(x.shape[1], device="cuda")
            hid, _ = decoder.forward(
                llm, lcfg, x, ar[None],
                ar[None, None, None, :] <= ar[None, None, :, None],
                return_hidden=True, ntk_ctx=cap)
            p = t.shape[0]
            lg = decoder.head_logits(llm, lcfg, hid[:, p - 1:p - 1 + len(
                toks)])[0].float()
            gaps = lg.max(-1).values - lg[torch.arange(len(toks),
                                                       device="cuda"), ids]
            hits += int((gaps == 0).sum())
            total += len(toks)
            worst = max(worst, gaps.max().item())
    print(f"{label}: {hits}/{total} emitted tokens are the argmax of a "
          f"teacher-forced prefill, the largest gap {worst:.3e} (allowed "
          f"{tol:.3e})", flush=True)
    if worst > tol:
        fail(f"{label}: an emitted greedy token {worst:.3e} below the "
             "argmax of a teacher-forced prefill")


def fp32_llm(llm, lcfg):
    import dataclasses
    return _norms_to_fp32(llm), dataclasses.replace(lcfg, dtype="float32")


def check_bank(card, params, cfg, tok, examples):
    """The LoRA bank (module docstring, phase 9)."""
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.serve.engine import (ServeRequest, ServingEngine,
                                                  prefill_group)
    llm, lcfg = params["llm"], cfg.llm
    layers = lcfg.num_layers
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    adapters = {n: random_adapter(lcfg, g) for n in ("loc", "go", "ec")}
    late = random_adapter(lcfg, g)
    reset_counts()
    tails, _ = keyword_tails(params, cfg, tok, examples[:BANK_REQUESTS])
    if min(t.shape[0] for t in tails) <= 256:
        fail("bank: a prompt of 256 tokens or fewer (every group must be "
             "n x bucket >= 256 rows for the int8 kernel)")
    bucket = round_up(max(t.shape[0] for t in tails), 64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(llm, lcfg, max_slots=SERVE_SLOTS,
                        max_len=bucket + 64, prefill_buckets=(bucket,),
                        steps_per_tick=SERVE_STEPS, seed=SEED,
                        lora_bank=adapters, adapter_capacity=4)
    names = ("loc", "go", "ec", None)
    t0 = time.perf_counter()
    done = eng.run([ServeRequest(i, embeds=e, max_new_tokens=64,
                                 temperature=0.1, top_p=0.7,
                                 eos_token_id=tok.eos_token_id,
                                 adapter_id=names[i % 4])
                    for i, e in enumerate(tails)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pre = eng.counters["prefills"]
    expect_counts("bank", read_counts(), flash_attention=layers * pre,
                  int8_matmul=7 * layers * pre,
                  **{n: cfg.esm.num_layers * -(-BANK_REQUESTS // 8)
                     for n in fe.launches})
    if len(done) != BANK_REQUESTS or eng.counters["completions"] != \
            BANK_REQUESTS:
        fail("bank: not every request was answered")
    bank_gib = sum(nbytes(*ab.values())
                   for ab in eng._lora_bank.values()) / 2**30
    print(f"bank: 3 adapters + base, {BANK_REQUESTS} requests in {dt:.2f} s, "
          f"{eng.counters['tokens'] / dt:.1f} tok/s, {pre} prefills, "
          f"{eng._tick} ticks; bank {bank_gib:.2f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the card "
          f"[{card}]", flush=True)
    # an adapter installed at runtime serves, and cannot be removed while
    # a request uses it
    eng.add_adapter("late", late)
    eng.submit(ServeRequest("late", embeds=tails[0], max_new_tokens=16,
                            eos_token_id=tok.eos_token_id,
                            adapter_id="late"))
    got = {c.request_id: c for c in eng.step()}
    try:
        eng.remove_adapter("late")
        fail("bank: remove_adapter of an adapter in use was not refused")
    except ValueError as e:
        print(f"bank: remove_adapter refused while in use ({e})", flush=True)
    got.update(eng.run([]))
    if "late" not in got or got["late"].finish_reason == "cancelled":
        fail("bank: the runtime adapter's request was not answered")
    eng.remove_adapter("late")
    # one admission group's first-token logits: the per-row gather
    # against each request through the 2-d lora_dense path in fp32
    embs, n_valid = group_embs(tails[:4], bucket)
    la = eng._gather_lora(torch.tensor(
        [eng._adapter_index.get(n, eng._zero_adapter) for n in names],
        device="cuda"))
    kw = dict(max_len=eng.max_len, lora=la)
    got = prefill_group(llm, lcfg, embs, n_valid, bucket, **kw)[0]
    plain = prefill_group(llm, lcfg, embs, n_valid, bucket, impl="torch",
                          **kw)[0]
    l32, c32 = fp32_llm(llm, lcfg)
    ref = torch.cat([prefill_group(
        l32, c32, embs[r:r + 1].float(), n_valid[r:r + 1], bucket,
        max_len=eng.max_len, lora=adapters.get(n), impl="torch")[0]
        for r, n in enumerate(names)])
    gate("bank: first-token logits, per-row gather vs 2-d lora_dense", got,
         plain, ref)
    del eng, la, adapters
    torch.cuda.empty_cache()
    return tails, bucket


def spec_run(llm, lcfg, tails, bucket, tok, temps, **kw):
    """One engine run of the requests `tails` at temperatures `temps`
    (top_p 0.7 where sampled): (completions, engine, seconds, per-tick
    records (tick-start active rows, consumed (S, rows)))."""
    import torch
    from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine
    eng = ServingEngine(llm, lcfg, max_slots=SERVE_SLOTS,
                        max_len=bucket + 64, prefill_buckets=(bucket,),
                        steps_per_tick=SERVE_STEPS, seed=SEED, **kw)
    records = []
    if eng.draft_layers:
        tick = eng._spec_tick

        def recorded(packed):
            out = tick(packed)
            records.append((packed[0] > 0, out[1][1]))
            return out
        eng._spec_tick = recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run([ServeRequest(i, embeds=e, max_new_tokens=64,
                                 temperature=t, top_p=0.7 if t else 1.0,
                                 eos_token_id=tok.eos_token_id)
                    for i, (e, t) in enumerate(zip(tails, temps))])
    torch.cuda.synchronize()
    return done, eng, time.perf_counter() - t0, records


def acceptance(label, records):
    """Every row active at a tick's start consumes 1..K tokens in each
    iteration until it finishes, then 0; rows inactive consume 0. Returns
    the mean tokens an active iteration."""
    total = iters = 0
    for active, cons in records:
        cons = cons.cpu()
        act = active.cpu()
        if int(cons.min()) < 0 or int(cons.max()) > SPEC_K:
            fail(f"{label}: an iteration consumed outside 0..{SPEC_K}")
        if bool((cons[:, ~act] != 0).any()) or bool(
                (cons[0, act] < 1).any()):
            fail(f"{label}: an active row consumed no token, or an "
                 "inactive one did")
        stopped = (cons == 0).int().cummax(0).values.bool()
        if bool((cons[stopped] != 0).any()):
            fail(f"{label}: a row resumed after it finished")
        total += int(cons.sum())
        iters += int((cons > 0).sum())
    return total / max(iters, 1)


def check_spec(card, params, cfg, tok, tails, bucket):
    """Self-speculative ticks (module docstring, phase 9)."""
    import torch
    from opus_pllm_tpu_torch.models import decoder
    from opus_pllm_tpu_torch.serve.engine import verify_mask
    llm, lcfg = params["llm"], cfg.llm
    layers = lcfg.num_layers
    tails = tails[:16]
    temps = [0.0] * 8 + [0.1] * 8
    spec_kw = dict(draft_layers=SPEC_DRAFT, spec_k=SPEC_K,
                   spec_adaptive=False)
    plain, peng, pdt, _ = spec_run(llm, lcfg, tails, bucket, tok, temps)
    reset_counts()
    done, eng, dt, records = spec_run(llm, lcfg, tails, bucket, tok, temps,
                                      **spec_kw)
    pre, iters = eng.counters["prefills"], eng._tick * eng.steps_per_tick
    expect_counts("speculative ticks", read_counts(),
                  flash_attention=layers * (pre + iters),
                  int8_matmul=7 * layers * pre)
    if len(done) != 16 or eng.counters["completions"] != 16:
        fail("speculative ticks: not every request was answered")
    mean = acceptance("speculative ticks", records)
    same = sum(done[i].tokens == plain[i].tokens for i in range(8))
    print(f"speculative ticks (draft {SPEC_DRAFT} layers, K {SPEC_K}), 8 "
          f"greedy + 8 sampled: {mean:.3f} tokens an iteration, "
          f"{eng.counters['tokens'] / dt:.1f} tok/s ({dt:.2f} s, "
          f"{eng._tick} ticks) vs plain ticks "
          f"{peng.counters['tokens'] / pdt:.1f} tok/s ({pdt:.2f} s, "
          f"{peng._tick} ticks); greedy requests equal to plain: {same}/8 "
          f"[{card}]", flush=True)
    # the verify pass through the kernels against the fp32 plain path,
    # over the engine's cache as the run left it
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    cap, b = eng.max_len, eng.max_slots + 1
    lengths = torch.randint(1, cap - SPEC_K, (b,), generator=g,
                            device="cuda")
    chunk = torch.randint(0, lcfg.vocab_size, (b, SPEC_K), generator=g,
                          device="cuda")
    mask = verify_mask(lengths, SPEC_K, cap)
    pos = lengths[:, None] + torch.arange(SPEC_K, device="cuda")[None]

    def verify(tree, c, dtype, impl):
        cache = {"layers": [{n: lc[n].to(dtype, copy=True)
                             for n in ("k", "v")}
                            for lc in eng.cache["layers"]],
                 "index": lengths.clone(), "mask": eng.cache["mask"]}
        with torch.no_grad():
            emb = decoder.embed_tokens(tree, chunk).to(dtype)
            lg, _ = decoder.forward(tree, c, emb, pos, mask, cache,
                                    impl=impl, ntk_ctx=cap)
        return lg.float()

    l32, c32 = fp32_llm(llm, lcfg)
    tol = 2 * gate(f"verify pass ({b} rows, K {SPEC_K}, cap {cap}) logits",
                   verify(llm, lcfg, torch.bfloat16, "auto"),
                   verify(llm, lcfg, torch.bfloat16, "torch"),
                   verify(l32, c32, torch.float32, "torch"))
    del peng, l32
    torch.cuda.empty_cache()
    teacher_forced("speculative ticks, greedy", llm, lcfg, tails[:8],
                   [done[i].tokens for i in range(8)], cap, tol)
    del eng
    # full acceptance: layers past the draft made the identity by a copy
    # of their o_proj / down_proj with zeros in it
    ident = dict(llm, layers=list(llm["layers"]))
    for i in range(SPEC_DRAFT, layers):
        lyr = dict(llm["layers"][i])
        for name in ("o_proj", "down_proj"):
            lyr[name] = dict(lyr[name], kernel_q=torch.zeros_like(
                lyr[name]["kernel_q"]))
        ident["layers"][i] = lyr
    greedy = [0.0] * 8
    plain, peng, pdt, _ = spec_run(ident, lcfg, tails[:8], bucket, tok,
                                   greedy)
    done, eng, dt, records = spec_run(ident, lcfg, tails[:8], bucket, tok,
                                      greedy, **spec_kw)
    mean = acceptance("full acceptance", records)
    same = sum(done[i].tokens == plain[i].tokens for i in range(8))
    for name, out in (("plain", plain), ("speculative", done)):
        teacher_forced(f"full acceptance, {name} ticks", ident, lcfg,
                       tails[:8], [out[i].tokens for i in range(8)],
                       eng.max_len, tol)
    print(f"full acceptance (layers {SPEC_DRAFT}-{layers - 1} the "
          f"identity), 8 greedy: {mean:.3f} tokens an iteration, "
          f"{eng.counters['tokens'] / dt:.1f} tok/s ({eng._tick} ticks) vs "
          f"plain {peng.counters['tokens'] / pdt:.1f} tok/s ({peng._tick} "
          f"ticks); equal to plain: {same}/8 [{card}]", flush=True)
    if mean < 2.0:
        fail(f"full acceptance: {mean:.3f} tokens an iteration")
    del ident, eng, peng
    torch.cuda.empty_cache()


def check_prefix(card, params, cfg, tok, examples, gen):
    """The prefix cache and engine reuse (module docstring, phase 9)."""
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.serve import engine as serve
    llm, lcfg = params["llm"], cfg.llm
    layers = lcfg.num_layers
    shapes = []
    prefill = serve.ServingEngine._run_prefill

    def recorded(self, bucket, embs, meta, n_real, prefix_id=None):
        shapes.append(embs.shape[0] * bucket)
        return prefill(self, bucket, embs, meta, n_real, prefix_id)
    serve.ServingEngine._run_prefill = recorded
    kw = dict(gen=gen, max_slots=SERVE_SLOTS, steps_per_tick=SERVE_STEPS,
              examples=examples, log_fn=lambda *_: None)
    reps, cache = [], {}
    try:
        for i in range(2):
            reset_counts()
            shapes.clear()
            reps.append(runner.run_annotation_eval_engine(
                params, cfg, tok, "synthetic_keywords.json",
                cache_prefix=True, engine_cache=cache, **kw))
            plen = reps[-1].engine["prefix_tokens"]
            pinned = i == 0          # the reused engine pins it no more
            big = sum(m >= 256 for m in shapes) + (pinned and plen >= 256)
            expect_counts(f"prefix cache, call {i + 1}", read_counts(),
                          flash_attention=layers * (len(shapes) + pinned),
                          int8_matmul=7 * layers * big,
                          **{n: cfg.esm.num_layers * -(-len(examples) // 8)
                             for n in fe.launches})
        shapes.clear()
        base = runner.run_annotation_eval_engine(
            params, cfg, tok, "synthetic_keywords.json", **kw)
    finally:
        serve.ServingEngine._run_prefill = prefill
    if plen < 16 or len(cache) != 1:
        fail(f"prefix cache: {plen}-token prefix, {len(cache)} engines")
    if [r["generated"] for r in reps[0].results] != \
            [r["generated"] for r in reps[1].results]:
        fail("engine reuse: the reseeded engine did not repeat its "
             "sampled output")
    for rep in (*reps, base):
        if rep.engine["completions"] != len(examples):
            fail("prefix cache: not every request was answered")
    print(f"prefix cache: {plen}-token header pinned once, "
          f"{plen * len(examples)} prefill tokens saved over "
          f"{len(examples)} requests; TTFT p50 / p99 <= "
          f"{reps[0].engine['ttft_p50']} / {reps[0].engine['ttft_p99']} s "
          f"(mean {reps[0].engine['ttft_mean']:.3f}) vs no prefix "
          f"{base.engine['ttft_p50']} / {base.engine['ttft_p99']} s (mean "
          f"{base.engine['ttft_mean']:.3f}); engine tok/s "
          f"{reps[0].decode_tokens / reps[0].decode_seconds:.1f} / "
          f"{base.decode_tokens / base.decode_seconds:.1f}; engine reuse: "
          f"1 engine for 2 calls, sampled output repeated bit for bit "
          f"[{card}]", flush=True)
    # first-token logits: prefix + suffix through the kernels against the
    # whole prompt through the fp32 plain path
    ex = examples[:8]
    full, ids = keyword_tails(params, cfg, tok, ex)
    sfx, _ = keyword_tails(params, cfg, tok, ex, plen)
    header = torch.tensor(ids[0][:plen], device="cuda")
    b_sfx = round_up(max(t.shape[0] for t in sfx), 64)
    b_full = round_up(max(t.shape[0] for t in full), 64)
    s_embs, s_valid = group_embs(sfx, b_sfx)
    f_embs, f_valid = group_embs(full, b_full)
    cap = plen + b_sfx + 64
    with torch.no_grad():
        pemb = llm["embed_tokens"]["embedding"][header]

        def via_prefix(impl):
            pref = serve.pin_prefix(llm, lcfg, pemb, max_len=cap, impl=impl)
            return serve.prefill_group(llm, lcfg, s_embs, s_valid, b_sfx,
                                       max_len=cap, prefix=pref,
                                       impl=impl)[0]
        l32, c32 = fp32_llm(llm, lcfg)
        ref = serve.prefill_group(l32, c32, f_embs.float(), f_valid, b_full,
                                  max_len=cap, impl="torch")[0]
        gate(f"prefix cache: first-token logits ({plen} + suffix vs the "
             "whole prompt)", via_prefix("auto"), via_prefix("torch"), ref)


def long_examples(n, lo=700, hi=960):
    """n keywords examples whose instructions make spliced prompts of
    lo..hi tokens (ByteTokenizer: one token a byte)."""
    import numpy as np
    from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
    rng = np.random.default_rng(SEED + 6)
    words = ("binds", "zinc", "membrane", "kinase", "domain", "protein",
             "residue", "catalytic", "helix", "sheet", "transport")
    out = []
    for e in synthetic_examples(n):
        want = int(rng.integers(lo, hi + 1)) - 300
        text = ""
        while len(text) < want:
            text += " " + words[int(rng.integers(len(words)))]
        out.append(AnnotationExample(
            "List the keywords of this protein, which" + text[:want] + "?",
            e.sequence, e.output))
    return out


def check_chunked(card, params, cfg, tok, examples):
    """Chunked prefill (module docstring, phase 9)."""
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    from opus_pllm_tpu_torch.models import decoder
    from opus_pllm_tpu_torch.serve import engine as serve
    llm, lcfg = params["llm"], cfg.llm
    layers = lcfg.num_layers
    longs, _ = keyword_tails(params, cfg, tok, long_examples(4))
    shorts, _ = keyword_tails(params, cfg, tok, examples[:12])
    lens = [t.shape[0] for t in longs]
    short_b = round_up(max(t.shape[0] for t in shorts), 64)
    if not (min(lens) > short_b and max(lens) + 64 <= CHUNK_CAP):
        fail(f"chunked prefill: long prompts of {lens} tokens")
    reqs = [(f"long{i}", t) for i, t in enumerate(longs)] + \
        [(f"short{i}", t) for i, t in enumerate(shorts)]

    def run(**kw):
        eng = serve.ServingEngine(llm, lcfg, max_slots=SERVE_SLOTS,
                                  max_len=CHUNK_CAP,
                                  steps_per_tick=SERVE_STEPS, seed=SEED,
                                  **kw)
        first = {}
        t0 = time.perf_counter()
        done = eng.run([serve.ServeRequest(
            rid, embeds=t, max_new_tokens=64, eos_token_id=tok.eos_token_id,
            temperature=0.1, top_p=0.7,
            on_tokens=lambda d, rid=rid: first.setdefault(
                rid, time.perf_counter() - t0)) for rid, t in reqs])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(done) != len(reqs) or eng.counters["completions"] != \
                len(reqs):
            fail("chunked prefill: not every request was answered")
        ttft = sorted(first[f"short{i}"] for i in range(len(shorts)))
        return eng, dt, ttft

    reset_counts()
    eng, dt, ttft = run(prefill_buckets=(short_b,), chunk_prefill=CHUNK)
    pre = eng.counters["prefills"]
    expect_counts("chunked prefill", read_counts(),
                  flash_attention=layers * pre,
                  int8_matmul=7 * layers * pre)
    _, mdt, mttft = run(prefill_buckets=(short_b, round_up(max(lens), 64)))
    print(f"chunked prefill ({CHUNK}-token chunks): 4 prompts of {lens} "
          f"tokens beside 12 of <= {short_b}: {pre} prefills (chunks "
          f"included), {eng.counters['tokens'] / dt:.1f} tok/s; the short "
          f"requests' TTFT median / max {ttft[len(ttft) // 2]:.3f} / "
          f"{ttft[-1]:.3f} s, vs one monolithic prefill bucket "
          f"{mttft[len(mttft) // 2]:.3f} / {mttft[-1]:.3f} s "
          f"({eng.counters['tokens'] / mdt:.1f} tok/s) [{card}]", flush=True)
    # each long prompt's first-token logits: its chunks through the
    # kernels against one monolithic prefill of it through the fp32 plain
    # path
    embs, n_valid = group_embs(longs, round_up(max(lens), CHUNK))

    def chunked(tree, c, x, impl):
        cache = decoder.init_cache(c, 4, CHUNK_CAP, device="cuda")
        out = [None] * 4
        for off in range(0, max(lens), CHUNK):
            rows = [r for r in range(4) if lens[r] > off]
            rt = torch.tensor(rows, device="cuda")
            nv = (n_valid[rt] - off).clamp_max(CHUNK)
            lg = serve.chunk_logits(
                tree, c, cache, x[rt, off:off + CHUNK], nv,
                torch.full_like(rt, off), rt, max_len=CHUNK_CAP, impl=impl)
            for i, r in enumerate(rows):
                if lens[r] <= off + CHUNK:
                    out[r] = lg[i]
        return torch.stack(out)

    l32, c32 = fp32_llm(llm, lcfg)
    with torch.no_grad():
        ref = []
        for r in range(4):
            n = lens[r]
            ar = torch.arange(n, device="cuda")
            hid, _ = decoder.forward(
                l32, c32, embs[r:r + 1, :n].float(), ar[None],
                (ar[None, None, None, :] <= ar[None, None, :, None]),
                impl="torch", return_hidden=True, ntk_ctx=CHUNK_CAP)
            ref.append(decoder.head_logits(l32, c32, hid[:, -1:],
                                           impl="torch")[0, 0].float())
        gate("chunked prefill: first-token logits vs one monolithic prefill",
             chunked(llm, lcfg, embs, "auto"),
             chunked(llm, lcfg, embs, "torch"), torch.stack(ref))


def check_engine_options(card, params, cfg, gen):
    """Phase 9 (module docstring): the int8 LLM of phase 8 behind the
    engine's LoRA bank, speculative ticks, prefix cache with engine reuse,
    and chunked prefill."""
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    tok = ByteTokenizer()
    examples = synthetic_examples(BANK_REQUESTS)
    walls = {}
    for name, fn in (
            ("bank", lambda: check_bank(card, params, cfg, tok, examples)),
            ("speculative ticks", lambda: check_spec(card, params, cfg, tok,
                                                     *bank_out)),
            ("prefix cache", lambda: check_prefix(card, params, cfg, tok,
                                                  examples[:16], gen)),
            ("chunked prefill", lambda: check_chunked(card, params, cfg, tok,
                                                      examples))):
        t0 = time.perf_counter()
        out = fn()
        if name == "bank":
            bank_out = out
        walls[name] = time.perf_counter() - t0
    print("engine options walls: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)


def http_call(port, path, body=None, method=None):
    """One HTTP request to the server on 127.0.0.1: JSON in, JSON (or the
    SSE events' data, or the text) out."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        kind = r.headers["Content-Type"]
        raw = r.read()
    if kind == "text/event-stream":
        return [line[len(b"data: "):].decode() for line in raw.split(b"\n\n")
                if line.startswith(b"data: ")]
    return json.loads(raw) if kind == "application/json" else raw.decode()


def check_server(card, params, cfg):
    """Phase 10 (module docstring): OpusServer over HTTP."""
    import dataclasses
    import threading
    import torch
    from opus_pllm_tpu_torch.bridge import cstp
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import decoder
    from opus_pllm_tpu_torch.serve.server import OpusServer
    params["llm"] = None                      # the int8 LLM of phase 8
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    params["llm"] = decoder.init(cfg.llm, generator=g, device="cuda")
    # text embeddings need a CSTP whose text side takes the served LLM's
    # hidden size (train-cstp's CSTPConfig(text_dim=4096))
    scfg = dataclasses.replace(cfg, cstp=dataclasses.replace(
        cfg.cstp, text_dim=cfg.llm.hidden_size))
    sparams = dict(params, cstp=cstp.init(scfg.cstp, generator=g,
                                          device="cuda"))
    bank = {n: random_adapter(cfg.llm, g) for n in ("loc", "go")}
    srv = OpusServer(sparams, scfg, ByteTokenizer(), max_slots=SERVER_SLOTS,
                     max_len=SERVER_LEN, steps_per_tick=SERVER_STEPS,
                     prefill_buckets=(64, 128, 256, 384),
                     cache_system_prefix=True, lora_bank=bank,
                     adapter_capacity=3, default_max_new=64)
    httpd = srv.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    layers = cfg.llm.num_layers
    try:
        reset_counts()
        pre0 = srv.engine.counters["prefills"]
        examples = synthetic_examples(SERVER_SLOTS)
        outs = [None] * SERVER_SLOTS

        def annotate(i):
            outs[i] = http_call(port, "/v1/annotate", {
                "instruction": examples[i].instruction,
                "sequence": examples[i].sequence, "max_new_tokens": 64,
                "temperature": 0.1, "top_p": 0.7,
                "adapter": (None, None, "loc", "go")[i % 4]})
        t0 = time.perf_counter()
        ts = [threading.Thread(target=annotate, args=(i,))
              for i in range(SERVER_SLOTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        dt = time.perf_counter() - t0
        if not all(o and o["tokens"] > 0 for o in outs):
            fail("server: not every /v1/annotate was answered")
        n_tok = sum(o["tokens"] for o in outs)
        ttft = srv.engine.latency["ttft"]
        print(f"server: {SERVER_SLOTS} concurrent /v1/annotate (4 on "
              f"'loc', 4 on 'go') in {dt:.2f} s, {n_tok / dt:.1f} tok/s; "
              f"TTFT p50 / p99 <= {ttft.percentile(0.5)} / "
              f"{ttft.percentile(0.99)} s (mean {ttft.mean:.3f}) [{card}]",
              flush=True)
        chat = {"messages": [{"role": "user", "content": [
                    {"type": "text", "text": "Which keywords fit?"},
                    {"type": "protein", "sequence": examples[0].sequence}]}],
                "max_tokens": 32}
        text = http_call(port, "/v1/chat/completions", chat)[
            "choices"][0]["message"]["content"]
        events = http_call(port, "/v1/chat/completions",
                           dict(chat, stream=True))
        streamed = "".join(json.loads(e)["choices"][0]["delta"].get(
            "content", "") for e in events[:-1])
        if events[-1] != "[DONE]" or streamed != text:
            fail("server: the streamed chat text differs from the "
                 "blocking one")
        comp = http_call(port, "/v1/completions", {
            "prompt": "The protein binds", "max_tokens": 16,
            "model": "loc"})
        if comp["model"] != "loc" or not comp["usage"]["completion_tokens"]:
            fail("server: /v1/completions on adapter 'loc' not answered")
        emb = http_call(port, "/v1/embeddings", {"input": [
            {"type": "protein", "sequence": examples[1].sequence},
            "A zinc-binding membrane kinase."]})
        vecs = [torch.tensor(d["embedding"]) for d in emb["data"]]
        if [tuple(v.shape) for v in vecs] != [(scfg.cstp.proj_dim,)] * 2 \
                or not all(bool(torch.isfinite(v).all()) for v in vecs):
            fail("server: /v1/embeddings shapes or values")
        models = http_call(port, "/v1/models")
        if [m["id"] for m in models["data"]] != \
                [srv.model_id, "loc", "go"]:
            fail(f"server: /v1/models lists {models}")
        if http_call(port, "/v1/adapters")["free"] != 1 or \
                http_call(port, "/health")["status"] != "ok":
            fail("server: /v1/adapters or /health")
        answered = SERVER_SLOTS + 3
        metrics = http_call(port, "/metrics")
        vals = {ln.split()[0]: float(ln.split()[1])
                for ln in metrics.splitlines()
                if ln and not ln.startswith("#")}
        if vals["opus_serve_completions_total"] != answered or \
                srv.engine.counters["completions"] != answered or \
                vals["opus_serve_ttft_seconds_count"] != answered:
            fail(f"server: /metrics counts "
                 f"{vals['opus_serve_completions_total']} completions, "
                 f"{answered} answered")
        pre = srv.engine.counters["prefills"] - pre0
        # each protein request is one ESM2 splice, and the protein
        # embedding one more ESM2 call; the text embedding one causal
        # prefill of the LLM
        expect_counts("server", read_counts(),
                      flash_attention=layers * (pre + 1),
                      **{n: cfg.esm.num_layers * (SERVER_SLOTS + 2 + 1)
                         for n in fe.launches})
        if not srv.drain(timeout=120):
            fail("server: drain did not finish")
        print(f"server: chat (blocking = SSE), completions on an adapter, "
              f"embeddings ({scfg.cstp.proj_dim}), models, adapters, "
              f"health, /metrics ({answered} completions), drain: ok; "
              f"{pre} prefills", flush=True)
    finally:
        httpd.shutdown()
        srv.close()
        params["llm"] = None
        torch.cuda.empty_cache()


def profile_serving(card):
    """The serving slice's device-time breakdown (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opus_pllm_tpu_torch.core.config import (ESM2Config, GenerationConfig,
                                                 OpusConfig)
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import quant
    from opus_pllm_tpu_torch.models import opus

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    params = opus.init(cfg, generator=g, device="cuda")
    params["llm"] = quant.quantize_decoder(params["llm"])
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    gen = GenerationConfig(max_new_tokens=64, temperature=0.1, top_p=0.7,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=SEED)
    examples = synthetic_examples(SERVE_REQUESTS)

    def run(n):
        rep = runner.run_annotation_eval_engine(
            params, cfg, tok, "synthetic_keywords.json", gen=gen,
            max_slots=SERVE_SLOTS, steps_per_tick=SERVE_STEPS,
            examples=examples[:n], log_fn=lambda *_: None)
        torch.cuda.synchronize()
        print(f"{n} requests: {rep.seconds:.3f} s wall, engine "
              f"{rep.decode_seconds:.3f} s for {rep.engine['decode_steps']} "
              f"decode steps and {rep.engine['prefills']} prefills "
              f"[{card}]", flush=True)

    for _ in range(2):
        run(SERVE_REQUESTS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(SERVE_SLOTS)
        wall = 1e3 * (time.perf_counter() - t0)
    # casts and multiplies: mostly the M=17 dequantize route's
    # int8->bf16 cast and scale multiply, with every other cast / multiply
    print_profile(prof, wall, card, {
        "casts (direct_copy_kernel)": "direct_copy_kernel",
        "multiplies (MulFunctor)": "MulFunctor",
        "int8_matmul_wgmma_kernel": "int8_matmul_wgmma_kernel",
        "flash_fwd_wgmma_kernel": "flash_fwd_wgmma_kernel",
        "flash mask packing (pack_row_words)": "pack_row_words",
        "cuBLAS (nvjet / gemm)": ("nvjet", "gemmSN", "gemv")})


def print_profile(prof, wall, card, groups):
    """Device time against the profiled wall `wall` (ms), summed per group
    of kernel-name keys, then the kernels with the most device time."""
    # device kernels and copies only: a CPU op's self device time repeats
    # the time of the kernels it launched
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA") and dev(e) > 0),
                     key=dev, reverse=True)
    busy = sum(dev(e) for e in kernels)
    print(f"profiled: {wall:.1f} ms wall, {busy:.1f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernels and copies ("
          f"{100 * busy / wall:.1f}% of the profiled wall) [{card}]",
          flush=True)
    for label, keys in groups.items():
        keys = (keys,) if isinstance(keys, str) else keys
        hit = [e for e in kernels if any(k in e.key for k in keys)]
        print(f"  {label:38s} {sum(dev(e) for e in hit):10.3f} ms in "
              f"{sum(e.count for e in hit)} launches", flush=True)
    for e in kernels[:20]:
        print(f"  {dev(e):10.3f} ms  {e.count:7d} x  {e.key[:100]}",
              flush=True)


def profile_training(card):
    """The training slice's device-time breakdown (module docstring): one
    bf16 step and one QLoRA step under torch.profiler, each after two
    unprofiled steps."""
    import itertools
    import json as _json
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opus_pllm_tpu_torch.core.config import (ESM2Config, LoRAConfig,
                                                 OpusConfig, TrainConfig)
    from opus_pllm_tpu_torch.core.util import to_device
    from opus_pllm_tpu_torch.data.collate import instruction_batches
    from opus_pllm_tpu_torch.data.datasets import InstructionDataset
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import opus
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    params = opus.init(cfg, generator=g, device="cuda")
    tok = ByteTokenizer()
    tcfg = TrainConfig(learning_rate=2e-5, weight_decay=0.0,
                       batch_size=TRAIN_BATCH, remat="full", ce_chunk=0,
                       grad_accum=1, log_every=1)
    lcfg = LoRAConfig(rank=16, alpha=32.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.json")
        with open(path, "w") as f:
            _json.dump(train_records(TRAIN_RECORDS, tok), f)
        batches = list(itertools.islice(instruction_batches(
            InstructionDataset(path), tok, TRAIN_BATCH, seed=SEED,
            max_len=TRAIN_MAX_LEN), 3))
    groups = {
        "flash_fwd_wgmma_kernel (forward + recompute)":
            "flash_fwd_wgmma_kernel",
        "flash_bwd_dq_wgmma_kernel": "flash_bwd_dq_wgmma_kernel",
        "flash_bwd_dkv_wgmma_kernel": "flash_bwd_dkv_wgmma_kernel",
        "flash mask packing (pack_row / col_words)": ("pack_row_words",
                                                      "pack_col_words"),
        "int4_v1_wgmma_kernel": "int4_v1_wgmma_kernel",
        "encoder kernels (fused_encoder.cu)": (
            "bf16_gemm_kernel", "bf16_gemm_io_kernel", "ln_rows_kernel",
            "encoder_attn_wgmma_kernel", "pack_key_words"),
        "cuBLAS bf16 (nvjet)": "nvjet",
        "cuBLAS fp32 (xmma_gemm_f32: LoRA, fp32 head)": "gemm_f32",
        "casts (direct_copy / bfloat16_copy)": ("direct_copy_kernel",
                                                "bfloat16_copy_kernel"),
        "adds (CUDAFunctor_add)": "CUDAFunctor_add",
        "other elementwise (Unary / BinaryFunctor)": ("AUnaryFunctor",
                                                      "BinaryFunctor",
                                                      "MulFunctor"),
        "softmax / log_softmax": ("SoftMax", "softmax")}
    for label in ("bf16 LLM", "int4-v1 LLM (QLoRA)"):
        if label.startswith("int4"):
            params["llm"] = quant4.quantize_decoder4(params["llm"],
                                                     layout="v1")
            torch.cuda.empty_cache()
        state, tx = mmt.create_state(cfg, tcfg, params, generator=g,
                                     train_switch=False, lora_cfg=lcfg,
                                     device="cuda")
        step = mmt.make_train_step(cfg, tx, lora_cfg=lcfg,
                                   remat=tcfg.remat_mode)
        placed = [to_device(b, "cuda") for b in batches]
        for b in placed[:2]:
            step(state, params, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, params, placed[2])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        print(f"training step, {label}:", flush=True)
        print_profile(prof, wall, card, groups)


# --- phases 14 and 15: the port's CLI and the checkpoint loaders -----------

CLI_EXAMPLES, CLI_NEW, CLI_BEAMS = 8, 16, 4
CLI_DRAFT, CLI_NDRAFT, CLI_RERUNS = 8, 4, 5


class Calls:
    """Wraps module attributes so that each call's positional and keyword
    arguments and result are kept (what a CLI run computed, for the gates
    and reruns after it);
    `restore` puts the originals back."""

    def __init__(self):
        self.calls, self._saved = {}, []

    def wrap(self, mod, name):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        store = self.calls.setdefault(name, [])

        def wrapped(*a, **k):
            out = orig(*a, **k)
            store.append((a, k, out))
            return out
        setattr(mod, name, wrapped)

    def restore(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []


def run_cli(argv):
    """opus_pllm_tpu_torch.cli.main.main(argv) in this process -> (its
    printed lines, seconds); the lines are echoed."""
    import contextlib
    import io
    from opus_pllm_tpu_torch.cli import main as cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    import torch
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print("   | " + line[:200], flush=True)
    return lines, dt


def saved_answers(label, path, n):
    with open(path) as f:
        res = json.load(f)
    if len(res) != n or not all(isinstance(r.get("generated"), str)
                                for r in res):
        fail(f"{label}: {len(res)} answers saved, {n} expected")


def tails_of(embeds, mask):
    """Each left-padded row's valid prompt embeddings (P, H)."""
    return [embeds[r][mask[r]] for r in range(embeds.shape[0])]


def prefill_logits(llm, lcfg, embeds, mask, impl):
    import torch
    from opus_pllm_tpu_torch.models import decoder
    with torch.no_grad():
        hid, _ = decoder.forward(llm, lcfg, embeds, decoder.positions_from_mask(
            mask), decoder.layers.causal_mask(mask), impl=impl,
            return_hidden=True)
        return decoder.head_logits(llm, lcfg, hid[:, -1]).float()


def beam_rank_gate(label, llm, lcfg, embeds, mask, out, k, margin):
    """Each token of each returned hypothesis is within the top 2K of a
    teacher-forced pass on the fp32 plain path at its position, up to
    `margin` (the logit bound of the kernel path, twice): beam search
    takes a token only among the 2K best continuations, so at most 2K - 1
    of its parent's tokens score higher. Prints the largest count of
    tokens above a returned one."""
    import torch
    from opus_pllm_tpu_torch.models import decoder
    l32, c32 = fp32_llm(llm, lcfg)
    worst = 0
    with torch.no_grad():
        for t, toks, n in zip(tails_of(embeds, mask), out.tokens,
                              out.lengths.tolist()):
            ids = toks[:n].long()
            x = torch.cat([t.float(), decoder.embed_tokens(
                l32, ids[:-1]).float()])[None]
            ar = torch.arange(x.shape[1], device="cuda")
            hid, _ = decoder.forward(
                l32, c32, x, ar[None],
                ar[None, None, None, :] <= ar[None, None, :, None],
                impl="torch", return_hidden=True)
            p = t.shape[0]
            lg = decoder.head_logits(l32, c32, hid[0, p - 1:p - 1 + n])
            picked = lg[torch.arange(n, device="cuda"), ids]
            above = (lg > picked[:, None] + margin).sum(-1)
            worst = max(worst, int(above.max()))
    print(f"{label}: the most fp32 teacher-forced logits above a returned "
          f"token (+{margin:.3e}) {worst}, allowed < {2 * k}", flush=True)
    if worst >= 2 * k:
        fail(f"{label}: a returned token ranks below the top {2 * k}")


def cache_like(lcfg, b, cap, quantize, g):
    """A cache of b rows filled with random values (every leaf)."""
    import torch
    from opus_pllm_tpu_torch.models import decoder
    cache = decoder.init_cache(lcfg, b, cap, device="cuda",
                               quantize=quantize)
    for lc in cache["layers"]:
        for t in lc.values():
            for x in (t.values() if isinstance(t, dict) else [t]):
                if x.dtype == torch.int8:
                    x.copy_(torch.randint(-128, 128, x.shape, generator=g,
                                          device="cuda", dtype=torch.int8))
                else:
                    x.copy_(torch.rand(x.shape, generator=g, device="cuda"))
    cache["mask"].copy_(torch.rand(cache["mask"].shape, generator=g,
                                   device="cuda") > 0.3)
    return cache


def reorder_gate(label, lcfg, b, cap, quantize, card):
    """One `reorder_cache` equals index_select on every leaf (scales "s"
    included) and on the mask, bit for bit; then its device time beside
    the bytes it must move (each leaf read and written once)."""
    import torch
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    cache = cache_like(lcfg, b, cap, quantize, g)
    rows = torch.randint(0, b, (b,), generator=g, device="cuda")
    moved = decoder.reorder_cache(cache, rows)
    leaves = lambda c: [x for lc in c["layers"] for t in lc.values()
                        for x in (t.values() if isinstance(t, dict)
                                  else [t])] + [c["mask"]]
    for a, x in zip(leaves(moved), leaves(cache)):
        if not torch.equal(a, x.index_select(0, rows)):
            fail(f"{label}: reorder_cache moved a leaf off its row")
    n = 2 * nbytes(*leaves(cache))
    ms = time_ms(lambda: decoder.reorder_cache(cache, rows), iters=5)
    print(f"{label}: reorder_cache of {b} rows x {cap} slots x "
          f"{lcfg.num_layers} layers equals index_select on every leaf; "
          f"{ms:.3f} ms a step, bound {1e3 * n / PEAK_HBM_BYTES:.3f} ms "
          f"({n / 1e9:.2f} GB read + written) [{card}]", flush=True)
    return ms


def new_shape_times(card, prompt_mask, cap_beam, cap_spec):
    """The kernels at the shapes this slice adds, each held against its
    plain version on the same inputs within phase 3's bound (`compare`),
    timed beside its bound: int4 v2 at M = B * K = 32 on the fused
    Llama-3-8B (K, N) the CLI decodes on, int8 at the fused widths (an
    8 x 256 prefill), both decode attentions over 32 reordered rows, flash
    at the static verify pass."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.infer.speculative import _decode_mask
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import quant, quant4
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 15)
    m = CLI_EXAMPLES * CLI_BEAMS
    for k, n in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                 (4096, 128256)):
        q, s = quant4.quantize_grouped(torch.randn((k, n), generator=g,
                                                   device="cuda"))
        p = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        compare(f"int4_matmul M={m} K={k} N={n}",
                lambda x: quant4.int4_matmul(x, p, s),
                lambda x: quant4.int4_matmul_plain(x, p, s), (x,), card,
                flops=2 * m * k * n, more_bytes=nbytes(p, s))
        del p, s
        torch.cuda.empty_cache()
    for n in (6144, 28672):
        wq, s = quant.quantize_per_channel(torch.randn((4096, n), generator=g,
                                                       device="cuda"))
        x = torch.randn((2048, 4096), generator=g, device="cuda").bfloat16()
        compare(f"int8_matmul M=2048 K=4096 N={n}",
                lambda x: quant.int8_matmul(x, wq, s),
                lambda x: quant.int8_matmul_plain(x, wq, s), (x,), card,
                flops=2 * 2048 * 4096 * n, more_bytes=nbytes(wq, s))
        del wq, s
        torch.cuda.empty_cache()
    from opus_pllm_tpu_torch.core.config import DecoderConfig
    lcfg = DecoderConfig(num_layers=1)
    l = prompt_mask.shape[1]
    qd = (torch.randn((m, 1, 32, 128), generator=g, device="cuda")
          * 0.5).bfloat16()
    for kind, quantize, fn in (
            ("int4", decoder._quantize_kv4, da.decode_attention_int4),
            ("int8", decoder._quantize_kv, da.decode_attention_int8)):
        # K / V quantized from normal values, as phase 3's are, then the
        # rows permuted as a beam step permutes them
        cache = decoder.init_cache(lcfg, m, cap_beam, device="cuda",
                                   quantize=kind)
        for name in ("k", "v"):
            for key, t in quantize(torch.randn(
                    (m, cap_beam, 8, 128), generator=g,
                    device="cuda")).items():
                cache["layers"][0][name][key].copy_(t)
        cache["mask"][:, :l] = prompt_mask.repeat_interleave(CLI_BEAMS, 0)
        cache["mask"][:, l:] = True
        cache = decoder.reorder_cache(cache, torch.randint(
            0, m, (m,), generator=g, device="cuda"))
        kl, vl = cache["layers"][0]["k"], cache["layers"][0]["v"]
        m4 = cache["mask"][:, None, None, :]
        compare(f"decode_attention_{kind} B={m} reordered cap={cap_beam}",
                lambda q: fn(q, kl, vl, m4),
                lambda q: da.decode_attention_plain(q, kl, vl, m4), (qd,),
                card, flops=4 * 32 * 128 * int(m4.sum()),
                n_bytes=decode_bytes(qd, kl, vl, m4))
        del cache, kl, vl
    cols = torch.arange(cap_spec, device="cuda")[None, None, None, :]
    mask = _decode_mask(prompt_mask, cap_spec, l + CLI_NDRAFT) & (
        cols <= l + torch.arange(CLI_NDRAFT, device="cuda")[
            None, None, :, None])
    qf = torch.randn((CLI_EXAMPLES, CLI_NDRAFT, 32, 128), generator=g,
                     device="cuda").bfloat16()
    kf, vf = (torch.randn((CLI_EXAMPLES, cap_spec, 8, 128), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    kx, vx = (t.repeat_interleave(4, dim=2).transpose(1, 2)
              for t in (kf, vf))
    qx = qf.transpose(1, 2)
    # the data's bytes: q and out, the mask, and the K / V rows some query
    # of the row may attend (left padding and the slots past l + n_draft
    # are never read), as phase 3's verify case counts them
    share = mask.any(2).float().mean().item()
    compare(f"flash_attention static verify B={CLI_EXAMPLES} "
            f"Sq={CLI_NDRAFT} Skv={cap_spec}",
            lambda q, k, v: fa.flash_attention(q, k, v, mask),
            lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
            (qf, kf, vf), card, flops=4 * 32 * 128 * int(mask.sum()),
            n_bytes=2 * nbytes(qf) + nbytes(mask) + share * nbytes(kf, vf),
            library=lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask))


def check_cli(card):
    """Phase 14 (module docstring): three `annotate` runs of the port's CLI
    at full width, random weights, the byte tokenizer in the HF
    tokenizer's place."""
    import tempfile
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.core.config import DecoderConfig
    from opus_pllm_tpu_torch.infer import engine, speculative
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe

    t_phase = time.perf_counter()
    print("cli: the card has no transformers, so cli.main.load_tokenizer "
          "returns ByteTokenizer(); nothing else of _build is changed",
          flush=True)
    cli.load_tokenizer = lambda path, family: ByteTokenizer()
    tok = ByteTokenizer()
    layers = DecoderConfig.llama3_8b().num_layers
    enc = {n: 33 for n in fe.launches}        # ESM2-650M, one batch of 8
    with tempfile.TemporaryDirectory() as tmp:
        test_json = os.path.join(tmp, "cli_keywords.json")
        with open(test_json, "w") as f:
            json.dump([{"instruction": e.instruction, "input": e.sequence,
                        "output": e.output}
                       for e in synthetic_examples(CLI_EXAMPLES)], f)
        base = ["annotate", "--model-base",
                os.path.join(tmp, "Meta-Llama-3-8B"), "--test-json",
                test_json, "--max-new-tokens", str(CLI_NEW),
                "--batch-size", str(CLI_EXAMPLES)]
        runs = (("beams", ["--num-beams", str(CLI_BEAMS),
                           "--temperature", "0"]),
                ("draft", ["--draft-layers", str(CLI_DRAFT), "--n-draft",
                           str(CLI_NDRAFT), "--temperature", "0"]),
                ("int4 beams", ["--load-int4", "--quantize-cache", "int4",
                                "--num-beams", str(CLI_BEAMS)]))
        for label, extra in runs:
            rec = Calls()
            rec.wrap(engine, "beam_generate")
            rec.wrap(speculative, "_speculative")
            save = os.path.join(tmp, label.replace(" ", "_") + ".json")
            torch.cuda.empty_cache()
            reset_counts()
            try:
                _, dt = run_cli(base + extra + ["--save-path", save])
            finally:
                rec.restore()
            counts = read_counts()
            saved_answers(f"cli {label}", save, CLI_EXAMPLES)
            print(f"cli {label}: {' '.join(extra)}: {dt:.1f} s end to end "
                  f"(weights drawn on the card included) [{card}]",
                  flush=True)
            if label == "draft":
                (a, k, out), = rec.calls["_speculative"]
                it = out.iterations
                expect_counts(f"cli {label}", counts, **enc,
                              flash_attention=layers + CLI_DRAFT
                              + layers * it)
                check_cli_draft(card, a, out)
                rerun_rates(f"cli {label}", out,
                            lambda: speculative._speculative(*a, **k), card)
            else:
                (a, k, out), = rec.calls["beam_generate"]
                want = dict(enc, flash_attention=layers)
                if label == "int4 beams":
                    # the CLI decodes on fused projections: [q|k|v], o,
                    # [gate|up] and down a layer, and the head
                    want.update(int4_matmul=1 + out.steps * (4 * layers + 1),
                                decode_attention_int4=layers * out.steps)
                expect_counts(f"cli {label}", counts, **want)
                check_cli_beams(card, label, a, out)
                rerun_rates(f"cli {label}", out,
                            lambda: engine.beam_generate(*a, **k), card)
            del rec, a, k, out
    torch.cuda.empty_cache()
    print(f"cli phase wall {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def rerun_rates(label, out, run, card):
    """The captured generation call run CLI_RERUNS more times on the same
    batch and weights: the CLI run's tokens a second and ms a step (beam
    steps, or verify passes), then the reruns' median and range. The loop
    is host-bound, so one run's rate is not a measurement."""
    import statistics
    rates, steps = [], []
    for o in [out] + [run() for _ in range(CLI_RERUNS)]:
        n = o.steps if hasattr(o, "steps") else o.iterations
        rates.append(int(o.lengths.sum()) / o.decode_seconds)
        steps.append(1e3 * o.decode_seconds / n)
    fmt = lambda v: (f"{statistics.median(v[1:]):.1f} (range {min(v[1:]):.1f}"
                     f" .. {max(v[1:]):.1f})")
    print(f"{label}: CLI run {rates[0]:.1f} tok/s, {steps[0]:.2f} ms a step;"
          f" {CLI_RERUNS} reruns on its batch: {fmt(rates)} tok/s, "
          f"{fmt(steps)} ms a step [{card}]", flush=True)


def check_cli_beams(card, label, a, out):
    """The gates on a CLI beam run's batch (its captured llm and spliced
    prompt): throughput, K = 1 equal to greedy, the top-2K ranks, the
    reorder's bit-exactness and time; after the int4 run, the kernel
    times at this slice's shapes."""
    import torch
    from opus_pllm_tpu_torch.infer import engine
    llm, lcfg, embeds, mask, pos = a[:5]
    n_tok = int(out.lengths.sum())
    print(f"cli {label}: {out.steps} beam steps, {n_tok} tokens in the 8 "
          f"best hypotheses (B*K = {CLI_EXAMPLES * CLI_BEAMS} rows)",
          flush=True)
    quantized = "kernel_p" in llm["layers"][0]["qkv_proj"]
    kw = dict(max_new_tokens=CLI_NEW, eos_token_id=2, pad_token_id=0)
    one = engine.beam_generate(llm, lcfg, embeds, mask, pos, num_beams=1,
                               **kw)
    greedy = engine.generate(llm, lcfg, embeds, mask, pos,
                             torch.Generator(device="cuda"),
                             temperature=0.0, **kw)
    if not (torch.equal(one.tokens, greedy.tokens)
            and torch.equal(one.lengths, greedy.lengths)):
        fail(f"cli {label}: num_beams = 1 differs from greedy")
    print(f"cli {label}: num_beams = 1 gives greedy's tokens", flush=True)
    tol = gate(f"cli {label} prefill logits ({embeds.shape[0]} x "
               f"{embeds.shape[1]})",
               prefill_logits(llm, lcfg, embeds, mask, "auto"),
               prefill_logits(llm, lcfg, embeds, mask, "torch"),
               prefill_logits(*fp32_llm(llm, lcfg), embeds.float(), mask,
                              "torch"))
    beam_rank_gate(f"cli {label}", llm, lcfg, embeds, mask, out, CLI_BEAMS,
                   2 * tol)
    cap = engine.cache_capacity(lcfg, embeds.shape[1], CLI_NEW)
    b = CLI_EXAMPLES * CLI_BEAMS
    if quantized:
        reorder_gate(f"cli {label} int4 cache", lcfg, b, cap, "int4", card)
        reorder_gate(f"cli {label} int8 cache", lcfg, b, cap, "int8", card)
        new_shape_times(card, mask, cap,
                        embeds.shape[1] + CLI_NEW + CLI_NDRAFT)
    else:
        reorder_gate(f"cli {label} bf16 cache", lcfg, b, cap, False, card)


def check_cli_draft(card, a, out):
    """The gates on the CLI draft run: tokens a second and per verify pass,
    the verify pass's logits through the kernels within the fp32 plain
    path's bound at its real shape, each emitted token within twice that
    bound of a teacher-forced prefill's argmax."""
    import torch
    from opus_pllm_tpu_torch.infer.speculative import _decode_mask
    from opus_pllm_tpu_torch.models import decoder
    _, llm, _, lcfg, embeds, _, mask, pos = a[:8]
    n_tok = int(out.lengths.sum())
    print(f"cli draft: {out.iterations} verify passes, {out.positions} "
          f"positions ({out.positions / out.iterations:.2f} a pass), "
          f"{n_tok} tokens", flush=True)
    b, l, _ = embeds.shape
    cap = l + CLI_NEW + CLI_NDRAFT
    chunk = out.tokens[:, :CLI_NDRAFT].long()

    def verify(tree, c, dtype, impl):
        cache = decoder.init_cache(c, b, cap, dtype=dtype, device="cuda")
        cache["mask"][:, :l] = mask
        ar = torch.arange(cap, device="cuda")
        with torch.no_grad():
            decoder.forward(tree, c, embeds.to(dtype), pos,
                            cache["mask"][:, None, None, :]
                            & (ar[None, None, None, :]
                               <= torch.arange(l, device="cuda")[
                                   None, None, :, None]),
                            cache, impl=impl, return_hidden=True)
            m4 = _decode_mask(mask, cap, l + CLI_NDRAFT) & (
                ar[None, None, None, :] <= l + torch.arange(
                    CLI_NDRAFT, device="cuda")[None, None, :, None])
            cpos = pos[:, -1:] + 1 + torch.arange(CLI_NDRAFT, device="cuda")
            hid, _ = decoder.forward(
                tree, c, decoder.embed_tokens(tree, chunk).to(dtype), cpos,
                m4, cache, impl=impl, return_hidden=True)
            return decoder.head_logits(tree, c, hid).float()

    tol = gate(f"cli draft verify pass logits (B {b}, Sq {CLI_NDRAFT}, "
               f"cap {cap})", verify(llm, lcfg, torch.bfloat16, "auto"),
               verify(llm, lcfg, torch.bfloat16, "torch"),
               verify(*fp32_llm(llm, lcfg), torch.float32, "torch"))
    teacher_forced("cli draft, greedy", llm, lcfg, tails_of(embeds, mask),
                   [out.tokens[r, :n].tolist()
                    for r, n in enumerate(out.lengths.tolist())], cap,
                   2 * tol)


LOAD_LAYERS, LOAD_RANK = 2, 16
SAFE_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16",
               "torch.float32": "F32", "torch.int8": "I8",
               "torch.uint8": "U8", "torch.int32": "I32",
               "torch.int64": "I64"}


def write_safetensors(path, tensors):
    """A `.safetensors` file written here: the 8-byte little-endian header
    length, the JSON header (padded to 8 bytes), the raw tensors."""
    import struct
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFE_DTYPES[str(t.dtype)],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(__import__(
                "torch").uint8).numpy().data)


def nf4_entry(w, key, g):
    """bitsandbytes NF4 with double quant of fp32 `w` (blocks of 64, the
    absmax stored 8-bit in blocks of 256 against a 256-entry map, offset
    by its mean), quantized here on the card -> (state-dict entries, the
    fp32 weights they decode to by bnb's rule, computed here)."""
    import numpy as np
    import torch
    from opus_pllm_tpu_torch.core.convert import NF4_CODE
    code = torch.from_numpy(NF4_CODE).cuda()
    nested = torch.linspace(-1.0, 1.0, 256, device="cuda")
    flat = w.reshape(-1, 64)
    absmax = flat.abs().amax(1)
    idx = torch.bucketize(flat / absmax[:, None],
                          (code[1:] + code[:-1]) / 2).to(torch.uint8)
    idx = idx.reshape(-1)
    offset = float(absmax.mean())
    cen = (absmax - offset).reshape(-1, 256)
    nmax = cen.abs().amax(1)
    q8 = torch.bucketize(cen / nmax[:, None],
                         (nested[1:] + nested[:-1]) / 2).to(torch.uint8)
    absmax_q = (nested[q8.long()] * nmax[:, None]).reshape(-1) + offset
    ref = (code[idx.long()].reshape(-1, 64) * absmax_q[:, None]).reshape(
        w.shape)
    meta = {"blocksize": 64, "shape": list(w.shape), "quant_type": "nf4",
            "nested_blocksize": 256, "nested_offset": offset,
            "dtype": "bfloat16"}
    cpu = lambda t: t.cpu().numpy()
    sd = {key: cpu((idx[0::2] << 4) | idx[1::2])[:, None],
          f"{key}.absmax": cpu(q8.reshape(-1)),
          f"{key}.nested_absmax": cpu(nmax),
          f"{key}.nested_quant_map": cpu(nested),
          f"{key}.quant_map": NF4_CODE.copy(),
          f"{key}.quant_state.bitsandbytes__nf4": np.frombuffer(
              json.dumps(meta).encode(), np.uint8).copy()}
    return sd, ref


def write_loader_files(tmp, g):
    """The files phase 15 reads, written here -> (paths, the written
    tensors on the card)."""
    import torch
    from opus_pllm_tpu_torch.core.config import DecoderConfig
    c = DecoderConfig.llama3_8b()
    h, f, kv = c.hidden_size, c.intermediate_size, c.num_kv_heads * 128
    rnd = lambda *s, scale=0.02, dt=torch.bfloat16: (torch.randn(
        s, generator=g, device="cuda") * scale).to(dt)
    w = {"model.embed_tokens.weight": rnd(c.vocab_size, h),
         "lm_head.weight": rnd(c.vocab_size, h),
         "model.norm.weight": 1 + rnd(h)}
    for i in range(LOAD_LAYERS):
        lp = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (h, h)),
                            ("self_attn.k_proj", (kv, h)),
                            ("self_attn.v_proj", (kv, h)),
                            ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (f, h)),
                            ("mlp.up_proj", (f, h)),
                            ("mlp.down_proj", (h, f))):
            w[lp + name + ".weight"] = rnd(*shape)
        w[lp + "input_layernorm.weight"] = 1 + rnd(h)
        w[lp + "post_attention_layernorm.weight"] = 1 + rnd(h)
    llm = os.path.join(tmp, "Meta-Llama-3-8B-2-layers")
    os.makedirs(llm)
    with open(os.path.join(llm, "config.json"), "w") as fh:
        json.dump({"vocab_size": c.vocab_size, "hidden_size": h,
                   "intermediate_size": f, "num_hidden_layers": LOAD_LAYERS,
                   "num_attention_heads": c.num_heads,
                   "num_key_value_heads": c.num_kv_heads,
                   "rope_theta": c.rope_theta, "rms_norm_eps": 1e-5,
                   "max_position_embeddings": 8192,
                   "tie_word_embeddings": False}, fh)
    names = sorted(w)
    for s in range(2):
        write_safetensors(os.path.join(llm, f"model-{s + 1:05d}-of-00002"
                                       ".safetensors"),
                          {k: w[k].cpu() for k in names[s::2]})
    # fair-esm ESM2 at 1280 wide, 2 layers, fp32, nested under "model"
    e = 1280
    esm = {"embed_tokens.weight": rnd(33, e, dt=torch.float32),
           "emb_layer_norm_after.weight": 1 + rnd(e, dt=torch.float32),
           "emb_layer_norm_after.bias": rnd(e, dt=torch.float32)}
    for i in range(LOAD_LAYERS):
        lp = f"layers.{i}."
        for n, shape in (("self_attn.q_proj", (e, e)),
                         ("self_attn.k_proj", (e, e)),
                         ("self_attn.v_proj", (e, e)),
                         ("self_attn.out_proj", (e, e)),
                         ("fc1", (4 * e, e)), ("fc2", (e, 4 * e))):
            esm[lp + n + ".weight"] = rnd(*shape, dt=torch.float32)
            esm[lp + n + ".bias"] = rnd(shape[0], dt=torch.float32)
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            esm[lp + n + ".weight"] = 1 + rnd(e, dt=torch.float32)
            esm[lp + n + ".bias"] = rnd(e, dt=torch.float32)
    esm_pt = os.path.join(tmp, "esm2_t2_1280.pt")
    torch.save({"model": {"encoder.sentence_encoder." + k: v.cpu()
                          for k, v in esm.items()},
                "args": {"encoder_layers": LOAD_LAYERS,
                         "encoder_embed_dim": e,
                         "encoder_attention_heads": 20}}, esm_pt)
    # the reference's weights directory
    wd = os.path.join(tmp, "opus-weights")
    for d in ("modality_encoder", "modality_refinement_projector",
              "lora_adapter"):
        os.makedirs(os.path.join(wd, d))
    cstp = {"protein_projection.linear.weight": rnd(5120, e,
                                                    dt=torch.float32),
            "protein_projection.linear.bias": rnd(5120, dt=torch.float32),
            "text_projection.linear.weight": rnd(5120, 5120,
                                                 dt=torch.float32),
            "text_projection.linear.bias": rnd(5120, dt=torch.float32)}
    torch.save({"state_dict": {k: v.cpu() for k, v in cstp.items()},
                "hyper_parameters": {"protein_projection_input_dim": e,
                                     "protein_projection_output_dim": 5120,
                                     "text_projection_input_dim": 5120,
                                     "text_projection_output_dim": 5120}},
               os.path.join(wd, "modality_encoder",
                            "modality_encoding_adapter.ckpt"))
    switch = {"switch_projector.0.weight": rnd(h * 8, 5120),
              "switch_projector.0.bias": rnd(h * 8)}
    torch.save({k: v.cpu() for k, v in switch.items()},
               os.path.join(wd, "modality_refinement_projector",
                            "modality_refinement_projection.bin"))
    lora = {}
    for i in range(LOAD_LAYERS):
        for key in [k for k in names if k.startswith(f"model.layers.{i}.")
                    and k.endswith("_proj.weight")]:
            stem = "base_model.model." + key[:-len(".weight")]
            out_d, in_d = w[key].shape
            lora[stem + ".lora_A.weight"] = rnd(LOAD_RANK, in_d,
                                                dt=torch.float32)
            lora[stem + ".lora_B.weight"] = rnd(out_d, LOAD_RANK,
                                                dt=torch.float32)
    write_safetensors(os.path.join(wd, "lora_adapter",
                                   "adapter_model.safetensors"),
                      {k: v.cpu() for k, v in lora.items()})
    with open(os.path.join(wd, "lora_adapter", "adapter_config.json"),
              "w") as fh:
        json.dump({"r": LOAD_RANK, "lora_alpha": 32, "peft_type": "LORA",
                   "task_type": "CAUSAL_LM", "target_modules": [
                       "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                       "up_proj", "down_proj"]}, fh)
    return (llm, esm_pt, wd), (w, esm, cstp, switch, lora)


def exact(label, got, want):
    import torch
    if got.dtype != want.dtype or not torch.equal(got, want):
        fail(f"{label}: loaded {got.dtype} {tuple(got.shape)} differs from "
             f"the written {want.dtype} {tuple(want.shape)}")


def check_loaded(params, unmerged, written):
    """Every loaded tensor equals the written one after the documented
    casts: torch (out, in) weights to (in, out) kernels, the LLM in bf16
    as written, ESM2 fp32 -> bf16 with q/k/v packed (3, E, E), CSTP fp32,
    the switch bf16 -> fp32, LoRA A / B fp32 as (in, r) / (r, out)."""
    import torch
    w, esm, cstp, switch, lora = written
    llm = params["llm"]
    exact("embed", llm["embed_tokens"]["embedding"],
          w["model.embed_tokens.weight"])
    exact("lm_head", llm["lm_head"]["kernel"], w["lm_head.weight"].t())
    exact("final norm", llm["final_norm"]["scale"], w["model.norm.weight"])
    names = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    for i, lp in enumerate(llm["layers"]):
        for ours, hf in names.items():
            key = f"model.layers.{i}.{hf}.weight"
            exact(key, lp[ours]["kernel"], w[key].t())
            stem = "base_model.model." + key[:-len(".weight")]
            exact(stem + " A", unmerged["layers"][i][ours]["A"],
                  lora[stem + ".lora_A.weight"].t())
            exact(stem + " B", unmerged["layers"][i][ours]["B"],
                  lora[stem + ".lora_B.weight"].t())
        exact(f"layer {i} norms", torch.stack([lp["attn_norm"]["scale"],
                                               lp["ffn_norm"]["scale"]]),
              torch.stack([w[f"model.layers.{i}.input_layernorm.weight"],
                           w[f"model.layers.{i}.post_attention_layernorm"
                             ".weight"]]))
    bf = lambda t: t.to(torch.bfloat16)
    exact("esm embed", params["esm"]["embed_tokens"]["embedding"],
          bf(esm["embed_tokens.weight"]))
    for i, lp in enumerate(params["esm"]["layers"]):
        pre = f"layers.{i}.self_attn."
        exact(f"esm {i} qkv", lp["qkv"]["kernel"], torch.stack(
            [bf(esm[pre + n + ".weight"]).t() for n in ("q_proj", "k_proj",
                                                      "v_proj")]))
        exact(f"esm {i} fc1", lp["fc1"]["kernel"],
              bf(esm[f"layers.{i}.fc1.weight"]).t())
    exact("cstp", params["cstp"]["protein_projection"]["kernel"],
          cstp["protein_projection.linear.weight"].t())
    exact("switch", params["switch"]["layers"][0]["kernel"],
          switch["switch_projector.0.weight"].float().t())


def check_loaders(card):
    """Phase 15 (module docstring): checkpoint files at Llama-3-8B / ESM2
    width, written here, through the readers, the CLI's train-lora and
    convert-weights, the server's adapter route and fused projections."""
    import tempfile
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.core import builder
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer

    t_phase = time.perf_counter()
    cli.load_tokenizer = lambda path, family: ByteTokenizer()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 16)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (llm_dir, esm_pt, wd), written = write_loader_files(tmp, g)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(tmp) for f in fs)
        print(f"loaders: wrote {size / 1e9:.2f} GB (two .safetensors "
              f"shards, a fair-esm .pt, the CSTP ckpt, the switch .bin, a "
              f"PEFT adapter) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        common = ["--model-base", llm_dir, "--esm", esm_pt, "--weights", wd,
                  "--switch-projector-type", "linear"]
        args = cli.build_parser().parse_args(["convert-weights", *common,
                                              "--out", tmp])
        cfg = cli._opus_config(args, builder.decoder_config_for(llm_dir))
        t0 = time.perf_counter()
        params, unmerged = builder.load_pretrained(
            llm_dir, wd, cfg, esm_path=esm_pt, merge_lora=False)
        torch.cuda.synchronize()
        print(f"loaders: load_pretrained (unmerged) "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check_loaded(params, unmerged, written)
        merged, _ = builder.load_pretrained(llm_dir, wd, cfg,
                                            esm_path=esm_pt)
        lora = written[4]
        worst = 0.0
        for i, lp in enumerate(merged["llm"]["layers"]):
            for key in [k for k in written[0] if k.startswith(
                    f"model.layers.{i}.") and k.endswith("_proj.weight")]:
                stem = "base_model.model." + key[:-len(".weight")]
                ref = written[0][key].t().float() + 2.0 * (
                    lora[stem + ".lora_A.weight"].t()
                    @ lora[stem + ".lora_B.weight"].t())
                got = lp[key.split(".")[-2]]["kernel"].float()
                worst = max(worst, ((got - ref).abs()
                                    - 2.0 ** -8 * ref.abs()).max().item())
        print(f"loaders: merged LoRA vs W + (alpha / r) A B in fp32: the "
              f"error past one bf16 rounding (2^-8 |ref|) at most "
              f"{worst:.3e} (allowed 1e-6)", flush=True)
        if worst > 1e-6:
            fail(f"loaders: the merged LoRA is off by {worst:.3e}")
        print("loaders: every loaded tensor equals the written one",
              flush=True)
        check_nf4(written[0], g)
        check_convert(card, common, tmp, merged)
        del merged
        check_server_adapter(card, params, cfg, unmerged, wd)
        check_fused(card, params["llm"], cfg.llm)
        del params, unmerged
        torch.cuda.empty_cache()
        check_train_cli(card, common, tmp)
    print(f"loaders phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def check_nf4(w, g):
    """One layer's seven projections as bitsandbytes NF4 with double
    quant: convert's dequantization equals this script's decoding
    exactly."""
    import torch
    from opus_pllm_tpu_torch.core import convert
    sd, refs = {}, {}
    t0 = time.perf_counter()
    for key in [k for k in w if k.startswith("model.layers.0.")
                and k.endswith("_proj.weight")]:
        entry, refs[key] = nf4_entry(w[key].float(), key, g)
        sd.update(entry)
    t1 = time.perf_counter()
    if not convert.has_bnb_4bit(sd):
        fail("nf4: the state dict is not recognized as bitsandbytes 4-bit")
    got = convert.dequantize_bnb_state_dict(sd)
    n = 0
    for key, ref in refs.items():
        out = torch.from_numpy(got[key]).cuda()
        if not torch.equal(out, ref):
            fail(f"nf4: {key} dequantizes {(out - ref).abs().max():.3e} "
                 "away from the reference")
        n += ref.numel()
    print(f"loaders: NF4 double-quant of one layer ({n / 1e6:.0f} M "
          f"weights, quantized in {t1 - t0:.1f} s) dequantizes exactly, in "
          f"{time.perf_counter() - t1:.1f} s on the host", flush=True)


def check_convert(card, common, tmp, merged):
    """convert-weights through the CLI, then load_native: bit for bit the
    tree load_pretrained assembles."""
    import torch
    from opus_pllm_tpu_torch.core import builder
    out = os.path.join(tmp, "native")
    _, dt = run_cli(["convert-weights", *common, "--out", out])
    t0 = time.perf_counter()
    back = builder.load_native(out)
    torch.cuda.synchronize()
    dl = time.perf_counter() - t0

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}.{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{pre}[{i}]")
        else:
            yield pre, t

    a, b = list(leaves(back)), list(leaves(merged))
    if [k for k, _ in a] != [k for k, _ in b]:
        fail("convert-weights: load_native gives another tree")
    for (k, x), (_, y) in zip(a, b):
        exact(f"native {k}", x, y)
    print(f"loaders: convert-weights {dt:.1f} s, load_native {dl:.1f} s: "
          f"{len(a)} leaves bit for bit [{card}]", flush=True)


def check_server_adapter(card, params, cfg, unmerged, wd):
    """POST /v1/adapters with the PEFT directory fills a free bank row; a
    greedy request through it equals the same adapter installed in memory
    (the bank path)."""
    import threading
    import urllib.request
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.lora import lora
    from opus_pllm_tpu_torch.serve.server import OpusServer
    srv = OpusServer(params, cfg, ByteTokenizer(),
                     lora_bank={"mem": lora.fold_scaling(unmerged, 2.0)},
                     adapter_capacity=2, max_slots=2, max_len=1024,
                     prefill_buckets=(512,), default_max_new=16)
    httpd = srv.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        t0 = time.perf_counter()
        info = post("/v1/adapters", {"name": "disk", "path": os.path.join(
            wd, "lora_adapter")})
        dt = time.perf_counter() - t0
        if info != {"adapters": ["disk", "mem"], "capacity": 2, "free": 0}:
            fail(f"POST /v1/adapters: {info}")
        ask = {"instruction": "What are the UniProtKB keywords of this "
               "protein?", "sequence": synthetic_examples(1)[0].sequence,
               "max_new_tokens": 16, "temperature": 0.0}
        disk = post("/v1/annotate", {**ask, "adapter": "disk"})
        mem = post("/v1/annotate", {**ask, "adapter": "mem"})
        if (disk["text"], disk["tokens"]) != (mem["text"], mem["tokens"]):
            fail(f"an adapter loaded from disk answers {disk} where the "
                 f"bank's answers {mem}")
        print(f"loaders: POST /v1/adapters loaded the PEFT directory in "
              f"{dt:.2f} s; a request through it equals the in-memory "
              f"bank's ({disk['tokens']} tokens) [{card}]", flush=True)
    finally:
        httpd.shutdown()
        srv.close()


def check_fused(card, llm, lcfg):
    """fuse_projections on the full-width int8 and int4 trees: an int8
    prefill of 8 x 64 rows and an int4 decode step through the kernels
    stay within phase 3's bound of the fp32 plain path, unfused and fused,
    with 4 quantized products a layer instead of 7."""
    import torch
    from opus_pllm_tpu_torch.kernels import quant, quant4
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 17)
    b, s = 8, 64
    x = (torch.randn((b, s + 1, lcfg.hidden_size), generator=g,
                     device="cuda") * 0.5).bfloat16()
    pos = torch.arange(s + 1, device="cuda")[None].expand(b, s + 1)
    ar = torch.arange(s, device="cuda")
    causal = (ar[None, None, None, :] <= ar[None, None, :, None]).expand(
        b, 1, s, s)
    layers = lcfg.num_layers

    def int8_prefill(tree, c, dtype, impl):
        with torch.no_grad():
            return decoder.forward(tree, c, x[:, :s].to(dtype), pos[:, :s],
                                   causal, impl=impl,
                                   return_hidden=True)[0].float()

    def int4_step(tree, c, dtype, impl, times=None):
        cache = decoder.init_cache(c, b, s + 1, dtype=dtype, device="cuda")
        cache["mask"][:] = True
        with torch.no_grad():
            m4 = (torch.arange(s + 1, device="cuda")[None, None, None, :]
                  <= ar[None, None, :, None]).expand(b, 1, s, s + 1)
            # the prompt through the plain path (no launch), then the step
            decoder.forward(tree, c, x[:, :s].to(dtype), pos[:, :s], m4,
                            cache, impl="torch", return_hidden=True)

            def step():
                cache["index"] = s
                return decoder.forward(
                    tree, c, x[:, s:].to(dtype), pos[:, s:],
                    cache["mask"][:, None, None, :], cache, impl=impl,
                    return_hidden=True)[0]
            out = step().float()
            if times is not None:       # device time, then as issued
                times += [time_ms(step), time_ms(step, hold=False)]
            return out

    for label, quantize, run, kernel in (
            ("int8 prefill 8 x 64", quant.quantize_decoder, int8_prefill,
             "int8_matmul"),
            ("int4 decode step B=8", quant4.quantize_decoder4, int4_step,
             "int4_matmul")):
        tree = quantize(llm)
        fused = decoder.fuse_projections(tree, lcfg)
        t32, c32 = fp32_llm(tree, lcfg)
        ref = run(t32, c32, torch.float32, "torch")
        plain = run(tree, lcfg, torch.bfloat16, "torch")
        n = {}
        for name, t in (("unfused", tree), ("fused", fused)):
            reset_counts()
            got = run(t, lcfg, torch.bfloat16, "auto")
            n[name] = read_counts()[kernel]
            gate(f"fused projections, {label}, {name}", got, plain, ref)
        print(f"fused projections, {label}: {kernel} launches {n['unfused']}"
              f" unfused, {n['fused']} fused ({layers} layers) [{card}]",
              flush=True)
        if n != {"unfused": 7 * layers, "fused": 4 * layers}:
            fail(f"fused projections, {label}: launches {n}, expected "
                 f"{7 * layers} and {4 * layers}")
        if run is int4_step:
            ms = {}
            for name, t in (("unfused", tree), ("fused", fused)):
                ms[name] = []
                run(t, lcfg, torch.bfloat16, "auto", ms[name])
            print("fused projections, int4 decode step B=8 "
                  f"({layers} layers and the head): device "
                  f"{ms['unfused'][0]:.4f} ms unfused, {ms['fused'][0]:.4f} "
                  f"ms fused; as issued {ms['unfused'][1]:.4f} ms unfused, "
                  f"{ms['fused'][1]:.4f} ms fused [{card}]", flush=True)
        del tree, fused, t32
        torch.cuda.empty_cache()


def check_train_cli(card, common, tmp):
    """train-lora through the CLI on the 2-layer model: 2 steps with
    --save-every 1 --export-reference-format, then --resume for a third;
    the same 2 steps with --load-int4 (QLoRA, the v1 kernel). Exact launch
    counts, a finite loss."""
    import math
    import torch
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    train = os.path.join(tmp, "train.json")
    with open(train, "w") as f:
        json.dump(train_records(3 * TRAIN_BATCH, ByteTokenizer()), f)
    base = {"flash_attention": 2 * LOAD_LAYERS,
            "flash_attention_bwd_dq": LOAD_LAYERS,
            "flash_attention_bwd_dkv": LOAD_LAYERS,
            **{n: LOAD_LAYERS for n in fe.launches}}
    for label, extra, steps, want in (
            ("train-lora", ["--max-steps", "2", "--save-every", "1",
                            "--export-reference-format"], 2, base),
            ("train-lora --resume", ["--max-steps", "3", "--resume"], 1,
             base),
            ("train-lora --load-int4", ["--max-steps", "2", "--load-int4"],
             2, dict(base, int4_matmul_v1=2 * 7 * LOAD_LAYERS + 1))):
        out = os.path.join(tmp, "lora-int4" if "int4" in label else "lora")
        torch.cuda.empty_cache()
        reset_counts()
        lines, dt = run_cli(["train-lora", *common, "--train-json", train,
                             "--out", out, *extra])
        expect_counts(f"cli {label}", read_counts(),
                      **{k: steps * v for k, v in want.items()})
        losses = [float(x.split("loss=")[1]) for x in lines
                  if "loss=" in x]
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"cli {label}: losses {losses}")
        final = int(extra[1])
        if f"saved trainable tree at step {final} -> {out}" not in lines:
            fail(f"cli {label}: no final save at step {final}")
        print(f"cli {label}: {steps} steps in {dt:.1f} s end to end, "
              f"loss {losses} [{card}]", flush=True)
    exported = os.path.join(tmp, "lora", "lora_adapter")
    if sorted(os.listdir(exported)) != ["adapter_config.json",
                                        "adapter_model.bin"]:
        fail(f"train-lora exported {os.listdir(exported)}")


# ---------------------------------------------------------------------------
# phase 16: the parallel axes of serving
# ---------------------------------------------------------------------------

PAR_RANKS = 4
PAR_EXAMPLES, PAR_NEW = 8, 12
SEQ_EXAMPLES, SEQ_NEW, SEQ_CHARS = 2, 8, 3900     # ~4k-token prompts
PAR_TIMEOUT = 900                                 # the phase's whole run
ACT_ALLOWANCE = 4 << 30                           # the run's working set
# (label, CLI flags, test file, examples, kind): kind "static", "engine"
# or "seq" says which generation call the run's gates capture
PAR_RUNS = (
    ("a mesh 1,4 bf16", ["--mesh", "1,4", "--batch-size", "8"], "short",
     PAR_EXAMPLES, "static"),
    ("b mesh 2,2 int4", ["--mesh", "2,2", "--load-int4", "--quantize-cache",
                         "int4", "--batch-size", "4"], "short", PAR_EXAMPLES,
     "static"),
    ("c engine mesh 1,4 int8", ["--engine", "--mesh", "1,4", "--load-int8",
                                "--quantize-cache", "int8", "--batch-size",
                                "8"], "short", PAR_EXAMPLES, "engine"),
    ("d seq-shards 4 bf16 cache", ["--seq-shards", "4", "--load-int8",
                                   "--batch-size", "2"], "long",
     SEQ_EXAMPLES, "seq"),
    ("d seq-shards 4 int8 cache", ["--seq-shards", "4", "--load-int8",
                                   "--quantize-cache", "int8",
                                   "--batch-size", "2"], "long",
     SEQ_EXAMPLES, "seq"),
)


def _tree_bytes(tree):
    import torch
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(
        tree, torch.Tensor) else 0


def par_one_run(rank, tmp, i):
    """Run i of PAR_RUNS on this rank through the port's CLI; what the
    gates need is saved to `tmp` (module docstring, phase 16)."""
    import contextlib
    import io
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.core import mesh as mesh_mod
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer import engine, sp_engine
    from opus_pllm_tpu_torch.serve import engine as serve_engine
    label, flags, which, n, kind = PAR_RUNS[i]
    rec = Calls()
    rec.wrap(engine, "generate")
    rec.wrap(sp_engine, "generate_seq_sharded")
    rec.wrap(serve_engine, "prefill_group")
    rec.wrap(runner, "splice_tails")
    rec.wrap(runner, "_engine_generate")
    for name in ("run_annotation_eval", "run_annotation_eval_engine"):
        orig = getattr(runner, name)

        def entry(*a, _orig=orig, **k):
            # the share is loaded: the peak from here is the run's
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec.calls.setdefault("params", []).append(
                (_tree_bytes(a[0]), _tree_bytes(a[0]["llm"])))
            return _orig(*a, **k)
        rec._saved.append((runner, name, orig))
        setattr(runner, name, entry)
    save = os.path.join(tmp, f"answers{i}.json")
    argv = (["annotate", "--model-base",
             os.path.join(tmp, "Meta-Llama-3-8B"), "--test-json",
             os.path.join(tmp, f"par_{which}_keywords.json"),
             "--max-new-tokens",
             str(SEQ_NEW if kind == "seq" else PAR_NEW),
             "--temperature", "0", "--save-path", save] + flags)
    torch.cuda.empty_cache()
    reset_counts()
    mesh_mod.reset_host_staged()
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"counts": read_counts(), "wall": wall,
           "peak": torch.cuda.max_memory_allocated(),
           "params": rec.calls["params"][0][0],
           "llm_bytes": rec.calls["params"][0][1],
           "host_staged": dict(mesh_mod.host_staged),
           "layout": par_layout(),
           "printed": buf.getvalue()}
    if kind == "static" or kind == "seq":
        fn = "generate" if kind == "static" else \
            "generate_seq_sharded"
        (a, k, out), = rec.calls[fn]
        llm, lcfg, embeds, mask, pos = a[:5]
        res.update(tokens=out.tokens.cpu(), lengths=out.lengths.cpu(),
                   steps=out.steps, decode_seconds=out.decode_seconds,
                   embeds=embeds.cpu(), mask=mask.cpu())
        if kind == "static":
            logits = prefill_logits(llm, lcfg, embeds, mask, "auto")
        else:
            logits = par_ring_logits(llm, lcfg, embeds, mask, pos,
                                     k["mesh"], SEQ_NEW)
        res["logits"] = None if logits is None else logits.cpu()
        if kind == "seq":
            slots = -(-embeds.shape[1] // k["mesh"].size) + SEQ_NEW
        else:
            slots = engine.cache_capacity(lcfg, embeds.shape[1],
                                          PAR_NEW)
        res["cache_bytes"] = par_cache_bytes(
            lcfg, embeds.shape[0], slots,
            k.get("quantize_cache", False))
    else:
        (a, k, (lg, _)), = rec.calls["prefill_group"][:1]
        (_, _, (toks, stats)), = rec.calls["_engine_generate"]
        (_, _, tails), = rec.calls["splice_tails"]
        res.update(tokens=toks, tails=[t.cpu() for t in tails],
                   logits=lg.cpu(), group_embs=a[2].cpu(),
                   n_valid=a[3].cpu(), bucket=a[4],
                   max_len=k["max_len"], quantize=k["quantize"],
                   prefills=stats["prefills"],
                   decode_steps=stats["decode_steps"],
                   decode_seconds=stats["seconds"])
        res["cache_bytes"] = par_cache_bytes(
            a[1], 17, k["max_len"], k["quantize"])
    torch.save(res, os.path.join(tmp, f"run{i}_rank{rank}.pt"))


def par_rank(rank, tmp, here):
    """One rank of phase 16: its process group (file rendezvous, the
    backend core.mesh picks), then every run of PAR_RUNS through the
    port's CLI, each run's captured prompt, tokens, first-step logits
    through this rank's share, launch counts and peak memory saved under
    `tmp` for the main process's gates. Any exception exits non-zero."""
    import datetime
    import gc
    import traceback
    try:
        sys.path.insert(0, here)
        import torch
        import torch.distributed as dist
        from opus_pllm_tpu_torch.cli import main as cli
        from opus_pllm_tpu_torch.core import mesh as mesh_mod
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh_mod.initialize_distributed(
            "file://" + os.path.join(tmp, "rendezvous"), PAR_RANKS, rank,
            device_type="cuda", timeout=datetime.timedelta(
                seconds=PAR_TIMEOUT))
        info = mesh_mod.backend_info()
        if rank == 0:
            print(f"parallel: {PAR_RANKS} ranks, backend {info['backend']}, "
                  f"sharing one card: {info['shared']}", flush=True)
        cli.load_tokenizer = lambda path, family: ByteTokenizer()
        for i in range(len(PAR_RUNS)):
            par_one_run(rank, tmp, i)
            # the run's share, caches and captured calls are gone: free
            # the cached blocks before the next run draws its own
            gc.collect()
            torch.cuda.empty_cache()
        par_collective_times(rank)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        print(f"rank {rank}:\n{traceback.format_exc()}", flush=True)
        os._exit(1)


def par_collective_times(rank):
    """Host-clock ms of the decode step's collectives at one shard of
    Llama-3-8B over 4 ranks (an fp32 all-reduce of 8 x 4096 after each
    row-parallel product, the all-gather of the head's 8 x 32064 logits)
    and of the prefill's all-reduce (8 x 384 x 4096), over the backend
    of this layout; printed by rank 0."""
    import torch
    import torch.distributed as dist
    from opus_pllm_tpu_torch.core import mesh as mesh_mod
    out = []
    for label, shape, gather in (("all_reduce", (8, 4096), False),
                                 ("all_gather", (8, 32064), True),
                                 ("all_reduce", (8 * 384, 4096), False)):
        x = torch.randn(shape, device="cuda")
        op = ((lambda: mesh_mod.all_gather_cat(x, None)) if gather
              else (lambda: mesh_mod.all_reduce(x, None)))
        for _ in range(3):
            op()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            op()
        torch.cuda.synchronize()
        out.append(f"{label} {'x'.join(map(str, shape))} fp32 "
                   f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms")
    if rank == 0:
        print(f"parallel collectives (host clock, {par_layout()}): "
              + "; ".join(out), flush=True)


def par_layout():
    """How the ranks sit: sharing one card (times are the rehearsal's) or
    a card each."""
    from opus_pllm_tpu_torch.core import mesh as mesh_mod
    info = mesh_mod.backend_info()
    if info["shared"]:
        return (f"{PAR_RANKS} ranks sharing one card over {info['backend']}:"
                " rehearsal times, not tensor-parallel speed")
    return f"{PAR_RANKS} ranks, a card each, over {info['backend']}"


def par_cache_bytes(lcfg, b, slots, quantize):
    """The bytes of the KV cache a rank holds: its heads, its slots."""
    per = {False: 2 * lcfg.head_dim, "int8": lcfg.head_dim + 4,
           True: lcfg.head_dim + 4, "int4": lcfg.head_dim // 2 + 4}[quantize]
    return 2 * lcfg.num_layers * b * slots * lcfg.num_kv_heads * per


def par_ring_logits(llm, lcfg, embeds, mask, pos, sp, new):
    """The sequence-sharded prefill's first-step logits (the last rank's
    head on the prompt's last row), or None on the other ranks."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.models import decoder
    n = sp.size
    b, l, _ = embeds.shape
    pad = -(-l // n) * n - l
    e = tnf.pad(embeds, (0, 0, pad, 0))
    m = tnf.pad(mask, (pad, 0))
    p = tnf.pad(pos, (pad, 0))
    l_loc = e.shape[1] // n
    sl = slice(sp.index * l_loc, (sp.index + 1) * l_loc)
    cache = decoder.init_cache(lcfg, b, l_loc, device=embeds.device)
    with torch.no_grad():
        hid, _ = decoder.forward(llm, lcfg, e[:, sl], p[:, sl], m[:, sl],
                                 cache, impl="ring", return_hidden=True,
                                 ntk_ctx=engine.cache_capacity(lcfg, l, new),
                                 sp=sp)
        if sp.index != n - 1:
            return None
        return decoder.head_logits(llm, lcfg, hid[:, -1:])[:, 0].float()


def par_examples(tmp):
    """The phase's test files: `short` (synthetic keywords requests, one
    batch) and `long` (an instruction of SEQ_CHARS bytes: ~4k-token
    prompts for the sequence-sharded cache)."""
    words = ("Describe the domains, the active sites, the localization "
             "and the UniProtKB keywords of this protein. ")
    long_instr = (words * (SEQ_CHARS // len(words) + 1))[:SEQ_CHARS]
    for name, exs in (("short", synthetic_examples(PAR_EXAMPLES)),
                      ("long", synthetic_examples(SEQ_EXAMPLES,
                                                  instruction=long_instr))):
        # the file name picks the task's metrics (keywords)
        with open(os.path.join(tmp, f"par_{name}_keywords.json"), "w") as f:
            json.dump([{"instruction": e.instruction, "input": e.sequence,
                        "output": e.output} for e in exs], f)


def par_single_llm(quantize):
    """The single process's Llama-3-8B as the CLI draws it (core/builder.py's
    LLM generator, seed 3, on this card), quantized as --load-int8 /
    --load-int4 quantize it."""
    import torch
    from opus_pllm_tpu_torch.core import builder
    from opus_pllm_tpu_torch.core.config import DecoderConfig
    from opus_pllm_tpu_torch.models import decoder
    lcfg = DecoderConfig.llama3_8b()
    q = lambda tree: builder._quantize_part(tree, quantize, "auto")
    llm = decoder.init(lcfg, generator=builder._generator(3, "cuda"),
                       device="cuda",
                       finish_head=lambda h: q({"lm_head": h,
                                                "layers": []})["lm_head"],
                       finish_layer=lambda lp: q({"layers": [lp]})[
                           "layers"][0])
    torch.cuda.synchronize()
    return llm, lcfg


def par_gates(card, i, res, llm, lcfg):
    """Run i's gates against the single process on this card: tokens
    equal across the ranks that generate together, every request
    answered, exact launch counts a step per rank, each rank's peak
    memory within its share plus the caches, the first step's logits
    within phase 3's bound of the fp32 plain path, and every greedy token
    within twice that bound of a teacher-forced single-process prefill's
    argmax."""
    import torch
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    label, flags, which, n, kind = PAR_RUNS[i]
    layers = lcfg.num_layers
    enc = {name: 33 for name in fe.launches}
    # the generating groups: data rows under --mesh 2,2, else every rank
    groups = ([[0, 1], [2, 3]] if "2,2" in flags else [list(range(PAR_RANKS))])
    for g in groups:
        for r in g[1:]:
            a, b = res[g[0]]["tokens"], res[r]["tokens"]
            same = (a == b if isinstance(a, list) else torch.equal(a, b))
            if not same:
                fail(f"parallel {label}: rank {r}'s tokens differ from rank "
                     f"{g[0]}'s")
    with open(os.path.join(res[0]["tmp"], f"answers{i}.json")) as f:
        saved = json.load(f)
    if len(saved) != n:
        fail(f"parallel {label}: {len(saved)} answers for {n} requests")
    for r, rr in enumerate(res):
        if kind == "static":
            want = dict(enc, flash_attention=layers)
            if "--load-int4" in flags:
                # fused [q|k|v], o, [gate|up], down a layer and the head a
                # step, the prefill's head once; the int4 cache's decode
                want.update(int4_matmul=1 + rr["steps"] * (4 * layers + 1),
                            decode_attention_int4=layers * rr["steps"])
        elif kind == "engine":
            want = dict(enc, flash_attention=layers * rr["prefills"],
                        int8_matmul=4 * layers * rr["prefills"],
                        decode_attention_int8=layers * rr["decode_steps"])
        else:
            want = dict(enc, int8_matmul=4 * layers)
        expect_counts(f"parallel {label} rank {r}", rr["counts"], **want)
        gib = lambda v: v / 2 ** 30
        lim = rr["params"] + rr["cache_bytes"] + ACT_ALLOWANCE
        print(f"parallel {label} rank {r}: peak {gib(rr['peak']):.2f} GiB "
              f"(share {gib(rr['params']):.2f} + cache "
              f"{gib(rr['cache_bytes']):.2f} + {gib(ACT_ALLOWANCE):.0f} GiB "
              f"of working set allowed); host-staged rotations "
              f"{rr['host_staged']['ring_shift']}", flush=True)
        if rr["peak"] > lim:
            fail(f"parallel {label} rank {r}: peak {gib(rr['peak']):.2f} GiB "
                 f"above {gib(lim):.2f} GiB")
    # no rank holds the whole LLM: a share is 1/M of the projections and
    # the head, with the embedding and the norms whole
    full, embed = _tree_bytes(llm), _tree_bytes(llm["embed_tokens"])
    m = (2 if "2,2" in flags else 4) if "--mesh" in flags else 1
    for r, rr in enumerate(res):
        want = (full - embed) / m + embed
        print(f"parallel {label} rank {r}: LLM share "
              f"{rr['llm_bytes'] / 2 ** 30:.2f} GiB of the whole "
              f"{full / 2 ** 30:.2f} (1/{m} of it a rank, the embedding "
              f"whole: {want / 2 ** 30:.2f})", flush=True)
        if rr["llm_bytes"] > 1.01 * want:
            fail(f"parallel {label} rank {r}: an LLM share of "
                 f"{rr['llm_bytes']} bytes, more than {want:.0f}")
    r0 = res[0]
    tok_n = (sum(len(t) for t in r0["tokens"]) if kind == "engine"
             else int(sum(int(rr["lengths"].sum()) for rr in
                          [res[g[0]] for g in groups])))
    per_step = (f", {1e3 * r0['decode_seconds'] / r0['steps']:.1f} ms a "
                f"step" if r0.get("steps") else "")
    print(f"parallel {label}: {n} requests, {tok_n} tokens, wall "
          f"{r0['wall']:.1f} s (weights drawn on the card included), decode "
          f"{r0['decode_seconds']:.2f} s{per_step} ({r0['layout']}) "
          f"[{card}]", flush=True)
    fp32 = fp32_llm(llm, lcfg)
    with torch.no_grad():
        if kind == "engine":
            from opus_pllm_tpu_torch.serve.engine import prefill_group
            e, nv = r0["group_embs"].cuda(), r0["n_valid"].cuda()
            kw = dict(max_len=r0["max_len"], quantize=r0["quantize"])
            got = r0["logits"].cuda()
            plain = prefill_group(llm, lcfg, e, nv, r0["bucket"],
                                  impl="torch", **kw)[0]
            ref = prefill_group(*fp32, e.float(), nv, r0["bucket"],
                                impl="torch", **kw)[0]
            tol = gate(f"parallel {label} prefill logits", got, plain, ref)
            teacher_forced(f"parallel {label}", llm, lcfg,
                           [t.cuda() for t in r0["tails"]], r0["tokens"],
                           r0["max_len"], 2 * tol)
            return
        for g in groups:
            rr = res[g[-1]] if kind == "seq" else res[g[0]]
            e, m = rr["embeds"].cuda(), rr["mask"].cuda()
            got = rr["logits"].cuda()
            plain = prefill_logits(llm, lcfg, e, m, "torch")
            ref = prefill_logits(*fp32, e.float(), m, "torch")
            tol = gate(f"parallel {label} first-step logits (ranks {g})",
                       got, plain, ref)
            tails = tails_of(e, m)
            outs = [row[:int(ln)].tolist() for row, ln in
                    zip(rr["tokens"], rr["lengths"])]
            cap = engine.cache_capacity(lcfg, e.shape[1], SEQ_NEW if kind ==
                                        "seq" else PAR_NEW)
            teacher_forced(f"parallel {label} (ranks {g})", llm, lcfg,
                           tails, outs, cap, 2 * tol)


def par_shard_kernels(card, rows):
    """Each kernel the phase's runs launch, at the shard shapes, held
    against its plain version (phase 3's compare): int4_matmul at M = 8
    (tensor parallelism over 4: N / 4, and K / 4 for o_proj and down_proj)
    and at run b's 4 rows over 2; int8_matmul at the engine prefill's M =
    8 x 384 over 4; flash_attention with 8 query and 2 KV heads; both
    decode attentions with 2 KV heads (run c) and 4 (run b)."""
    import torch
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import quant, quant4
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 16)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    d = 128

    def shards(m):
        return ((4096, (32 + 16) * d // m), (32 * d // m, 4096),
                (4096, 2 * 14336 // m), (14336 // m, 4096),
                (4096, 128256 // m))
    for rows_m, m in ((8, 4), (4, 2)):
        for k, n in shards(m):
            q, s = quant4.quantize_grouped(
                torch.randn((k, n), generator=g, device="cuda"))
            packed = quant4.pack_int4_v2(q)
            x = rnd(rows_m, k)
            print(f"int4_matmul M={rows_m} K={k} N={n}: variant "
                  f"{quant4.v2_kernel_variant(n)}", flush=True)
            keep(rows, "int4_matmul", compare(
                f"int4_matmul M={rows_m} K={k} N={n} (TP {m})",
                lambda x: quant4.int4_matmul(x, packed, s),
                lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
                flops=2 * rows_m * k * n, more_bytes=nbytes(packed, s)),
                False)
            del q, s, packed
    for k, n in shards(4)[:4]:
        wq, s = quant.quantize_per_channel(
            torch.randn((k, n), generator=g, device="cuda"))
        x = rnd(8 * 384, k)
        print(f"int8_matmul K={k} N={n}: variant "
              f"{quant.kernel_variant(k, n)}", flush=True)
        keep(rows, "int8_matmul", compare(
            f"int8_matmul M={8 * 384} K={k} N={n} (TP 4)",
            lambda x: quant.int8_matmul(x, wq, s),
            lambda x: quant.int8_matmul_plain(x, wq, s), (x,), card,
            flops=2 * 8 * 384 * k * n, more_bytes=nbytes(wq, s)), False)
        del wq, s
    b, l = 8, 384
    pad = torch.randint(0, l // 2, (b,), generator=g, device="cuda")
    valid = torch.arange(l, device="cuda")[None] >= pad[:, None]
    mask = decoder.layers.causal_mask(valid)
    q, kk, vv = rnd(b, l, 8, d), rnd(b, l, 2, d), rnd(b, l, 2, d)
    keep(rows, "flash_attention", compare(
        "flash_attention 8 x 384 causal, 8 q / 2 kv heads (TP 4)",
        lambda q, k, v: fa.flash_attention(q, k, v, mask),
        lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
        (q, kk, vv), card, flops=4 * 8 * d * mask.sum().item(),
        more_bytes=nbytes(mask)), False)
    for kind, quant_kv, fn, bb, hkv, cap in (
            ("int8", decoder._quantize_kv, da.decode_attention_int8, 17, 2,
             448),
            ("int4", decoder._quantize_kv4, da.decode_attention_int4, 4, 4,
             396)):
        lengths = torch.randint(cap // 2, cap + 1, (bb,), generator=g,
                                device="cuda")
        m4 = (torch.arange(cap, device="cuda")[None]
              < lengths[:, None])[:, None, None, :]
        kl, vl = ({key: t.contiguous() for key, t in quant_kv(torch.randn(
            (bb, cap, hkv, d), generator=g, device="cuda")).items()}
            for _ in range(2))
        qd = rnd(bb, 1, 4 * hkv, d)
        keep(rows, f"decode_attention_{kind}", compare(
            f"decode_attention_{kind} B={bb} cap={cap} {hkv} kv heads",
            lambda q: fn(q, kl, vl, m4),
            lambda q: da.decode_attention_plain(q, kl, vl, m4), (qd,), card,
            flops=4 * 4 * hkv * d * m4.sum().item(),
            n_bytes=decode_bytes(qd, kl, vl, m4)), False)


def check_parallel(card, rows):
    """Phase 16 (module docstring): PAR_RANKS ranks on this card run the
    port's CLI with --mesh and --seq-shards at full width; their results
    are gated against a single process here."""
    import gc
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="opus-parallel-")
    try:
        par_examples(tmp)
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=par_rank, args=(r, tmp, here))
                 for r in range(PAR_RANKS)]
        for p in procs:
            p.start()
        end = time.monotonic() + PAR_TIMEOUT
        while any(p.is_alive() for p in procs) and time.monotonic() < end:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        if codes != [0] * PAR_RANKS:
            fail(f"parallel: rank exit codes {codes} (None: still running "
                 f"after {PAR_TIMEOUT} s)")
        print(f"parallel: {len(PAR_RUNS)} runs of {PAR_RANKS} ranks in "
              f"{time.perf_counter() - t_phase:.1f} s (spawn, start-up and "
              f"the weights' draws included) [{card}]", flush=True)
        results = []
        for i in range(len(PAR_RUNS)):
            res = [torch.load(os.path.join(tmp, f"run{i}_rank{r}.pt"),
                              weights_only=False) for r in range(PAR_RANKS)]
            res[0]["tmp"] = tmp
            for line in res[0]["printed"].splitlines():
                print("   | " + line[:200], flush=True)
            results.append(res)
        for quantize, runs in ((None, (0,)), ("int4", (1,)),
                               ("int8", (2, 3, 4))):
            llm, lcfg = par_single_llm(quantize)
            for i in runs:
                par_gates(card, i, results[i], llm, lcfg)
            del llm
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    par_shard_kernels(card, rows)
    torch.cuda.empty_cache()
    print(f"parallel phase wall {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 17: the trainers on the mesh and serve's lockstep mesh
# ---------------------------------------------------------------------------

PT_RANKS, PT_STEPS = 4, 2
PT_LAYERS_SHARED = 8       # training depth when the ranks share one card
PT_CE_CHUNK_SHARED = 64    # and the chunked cross-entropy there
PT_TIMEOUT = 900           # the phase's whole run
PT_CSTP_PAIRS, PT_CSTP_BATCH = 256, 128
PT_SERVE_NEW = 12
PT_LORA_LR = 2e-5          # train-lora's default
PT_CSTP_LR = 0.05          # train-cstp's default
PT_LOSS_RTOL = 2 ** -7     # bf16 train-lora losses: one bf16 rounding
PT_GRAD_RTOL = 2 ** -4     # bf16 LoRA gradients, of each leaf's largest
PT_CSTP_RTOL = 1e-5        # fp32 CSTP losses
PT_CSTP_GRAD_RTOL = 1e-4   # fp32 CSTP gradients, of each leaf's largest
PT_RUNS = (   # (label, kind, flags)
    ("lora bf16 mesh 2,2", "lora", ["--mesh", "2,2"]),
    ("lora int4-v1 mesh 2,2", "lora", ["--mesh", "2,2", "--load-int4"]),
    ("cstp mesh 4", "cstp", ["--mesh", "4"]),
    ("serve mesh 1,4 int8", "serve", ["--mesh", "1,4", "--load-int8",
                                      "--cache-system-prefix",
                                      "--adapter-slots", "2"]),
)


def pt_shared():
    """True when the phase's ranks share this one card (gloo)."""
    import torch
    return torch.cuda.device_count() < PT_RANKS


def pt_depth(layers):
    """Cut the CLI's Llama-3-8B preset to `layers` layers (None: whole):
    core.builder.decoder_config_for wrapped; returns the original."""
    import dataclasses
    from opus_pllm_tpu_torch.core import builder
    orig = builder.__dict__.get("_pt_orig", builder.decoder_config_for)
    builder._pt_orig = orig
    builder.decoder_config_for = (
        orig if layers is None else
        lambda path: dataclasses.replace(orig(path), num_layers=layers))
    return orig


def pt_files(tmp):
    """The phase's inputs: the train-lora records, the stage-(a) pairs
    (ESM2-650M and Llama-3-8B widths) and two PEFT adapter directories
    (rank 4 on q_proj and v_proj, every layer)."""
    import pickle
    import numpy as np
    import torch
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    with open(os.path.join(tmp, "train.json"), "w") as f:
        # a few spare records: the 512-token cap drops some
        json.dump(train_records((PT_STEPS + 1) * TRAIN_BATCH,
                                ByteTokenizer()), f)
    rng = np.random.default_rng(SEED + 17)
    with open(os.path.join(tmp, "pairs.pkl"), "wb") as f:
        pickle.dump([{"seq_embedding": rng.standard_normal(1280).astype(
                          np.float32),
                      "text_embedding": rng.standard_normal(4096).astype(
                          np.float32)} for _ in range(PT_CSTP_PAIRS)], f)
    g = torch.Generator().manual_seed(SEED + 17)
    for name in ("a", "b"):
        d = os.path.join(tmp, f"adapter_{name}")
        os.makedirs(d)
        with open(os.path.join(d, "adapter_config.json"), "w") as f:
            json.dump({"r": 4, "lora_alpha": 8, "peft_type": "LORA",
                       "task_type": "CAUSAL_LM",
                       "target_modules": ["q_proj", "v_proj"]}, f)
        sd = {}
        for i in range(32):
            for proj, out in (("q_proj", 4096), ("v_proj", 1024)):
                stem = f"base_model.model.model.layers.{i}.self_attn.{proj}"
                sd[stem + ".lora_A.weight"] = torch.randn(
                    (4, 4096), generator=g) * 0.01
                sd[stem + ".lora_B.weight"] = torch.randn(
                    (out, 4), generator=g) * 0.01
        write_safetensors(os.path.join(d, "adapter_model.safetensors"), sd)


def pt_argv(tmp, i, out, mesh=True):
    """Run i's command line (without its mesh flags when `mesh` is
    False: the single process's)."""
    label, kind, flags = PT_RUNS[i]
    if not mesh:
        flags = [f for j, f in enumerate(flags)
                 if f != "--mesh" and (j == 0 or flags[j - 1] != "--mesh")]
    model = ["--model-base", os.path.join(tmp, "Meta-Llama-3-8B")]
    if kind == "lora":
        chunk = PT_CE_CHUNK_SHARED if pt_shared() else 0
        return (["train-lora"] + model + [
            "--train-json", os.path.join(tmp, "train.json"), "--out", out,
            "--max-steps", str(PT_STEPS), "--save-every", "1",
            "--ce-chunk", str(chunk)] + flags)
    if kind == "cstp":
        return ["train-cstp", "--vec-pickle", os.path.join(tmp, "pairs.pkl"),
                "--out", out, "--max-steps", str(PT_STEPS), "--save-every",
                "1"] + flags
    return (["serve"] + model + [
        "--host", "127.0.0.1", "--port", out, "--max-new-tokens",
        str(PT_SERVE_NEW), "--drain-grace", "30", "--adapter",
        "a=" + os.path.join(tmp, "adapter_a")] + flags)


def pt_record_training():
    """Wrap the optimizer's step and the trainers' step factories: every
    step's metrics and the gradients AdamW takes, gathered whole on a
    mesh (each rank calls the gather; rank 0 keeps them) -> (the record,
    a function restoring the originals)."""
    import torch.distributed as dist
    from opus_pllm_tpu_torch.parallel import partition
    from opus_pllm_tpu_torch.train import cstp_trainer as ct
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    from opus_pllm_tpu_torch.train import optim
    seen = {"grads": [], "metrics": []}
    keep = not dist.is_initialized() or dist.get_rank() == 0
    orig_step = optim.AdamW.step

    def step(self):
        grads = [p.grad.detach() for p in self.params]
        if self.layout is not None:
            grads = partition.uncut_leaves(grads, self.layout)
        if keep:
            seen["grads"].append([g.float().cpu() for g in grads])
        return orig_step(self)
    saved = [(optim.AdamW, "step", orig_step)]
    optim.AdamW.step = step
    for mod in (mmt, ct):
        orig = mod.make_train_step

        def make(*a, _orig=orig, **k):
            fn = _orig(*a, **k)

            def run(state, *args):
                state, m = fn(state, *args)
                seen["metrics"].append({key: float(v)
                                        for key, v in m.items()})
                seen.setdefault("stamps", []).append(time.perf_counter())
                return state, m
            return run
        saved.append((mod, "make_train_step", orig))
        mod.make_train_step = make

    def restore():
        for obj, name, orig in saved:
            setattr(obj, name, orig)
    return seen, restore


def pt_serve_client(port, tmp, got):
    """Rank 0's client: wait for /health, then 8 requests (4 greedy
    annotate requests at once, a greedy and a sampled generate, one
    cancelled by its timeout, one adapter added, then one greedy request
    under it), /health and /metrics, and SIGTERM to this process."""
    import signal
    import threading
    import urllib.request
    end = time.monotonic() + 600
    while time.monotonic() < end:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=5):
                break
        except OSError:
            time.sleep(0.5)
    got["t0"] = time.perf_counter()
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWYACDEFGH",
            "MSTNPKPQRKTKRNTNRRPQDVKFPGG", "MVLSPADKTNVKAAWGKVGAHAGEYGAE"]
    greedy = [("/v1/annotate", {"instruction": "What are the UniProtKB "
               "keywords of this protein?", "sequence": s,
               "max_new_tokens": PT_SERVE_NEW, "temperature": 0.0})
              for s in seqs]
    answers = [None] * len(greedy)

    def send(j):
        answers[j] = http_call(port, *greedy[j])
    threads = [threading.Thread(target=send, args=(j,))
               for j in range(len(greedy))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got["greedy"] = answers
    prompt = "The protein kinase domain " * 4
    got["generate"] = http_call(port, "/v1/generate", {
        "prompt": prompt, "max_new_tokens": PT_SERVE_NEW,
        "temperature": 0.0})
    got["sampled"] = http_call(port, "/v1/generate", {
        "prompt": prompt, "max_new_tokens": PT_SERVE_NEW,
        "temperature": 0.7, "top_p": 0.9})
    try:
        got["cancelled"] = http_call(port, "/v1/generate", {
            "prompt": prompt, "max_new_tokens": 700, "temperature": 0.0,
            "_timeout": 0.3})
    except Exception as e:   # noqa: BLE001 — the 504 is the expected end
        got["cancelled"] = repr(e)
    got["adapter"] = http_call(port, "/v1/adapters", {
        "name": "b", "path": os.path.join(tmp, "adapter_b")})
    got["under_b"] = http_call(port, "/v1/generate", {
        "prompt": prompt, "max_new_tokens": PT_SERVE_NEW,
        "temperature": 0.0, "adapter": "b"})
    got["wall"] = time.perf_counter() - got["t0"]
    got["health"] = http_call(port, "/health")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        got["metrics"] = r.read().decode()
    os.kill(os.getpid(), signal.SIGTERM)


def pt_one_run(rank, tmp, i, layers):
    """Run i of PT_RUNS on this rank through the port's CLI; what the
    gates need is saved to `tmp` (module docstring, phase 17)."""
    import contextlib
    import io
    import signal
    import threading
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.serve import engine as serve_engine
    from opus_pllm_tpu_torch.serve import server
    label, kind, flags = PT_RUNS[i]
    pt_depth(layers if kind == "lora" else None)
    res = {}
    out = os.path.join(tmp, f"out{i}")
    restore = lambda: None    # noqa: E731
    rec = Calls()
    if kind == "serve":
        port = int(open(os.path.join(tmp, "port")).read())
        argv = pt_argv(tmp, i, str(port))
        if rank == 0:
            got = res.setdefault("client", {})
            threading.Thread(target=pt_serve_client, args=(port, tmp, got),
                             daemon=True).start()
            rec.wrap(serve_engine, "prefill_group")
            reqs, done = res.setdefault("requests", {}), res.setdefault(
                "done", {})
            submit = serve_engine.ServingEngine.submit
            deliver = server.OpusServer._deliver

            def sub(self, req):
                submit(self, req)
                e = req.embeds
                reqs[req.request_id] = {
                    "embeds": e.detach().cpu() if e is not None else None,
                    "token_ids": req.token_ids,
                    "prefix_id": req.prefix_id, "adapter": req.adapter_id,
                    "temperature": req.temperature}

            def dlv(self, rid, result):
                done[rid] = (list(result.tokens) if hasattr(result, "tokens")
                             else repr(result))
                deliver(self, rid, result)
            serve_engine.ServingEngine.submit = sub
            server.OpusServer._deliver = dlv

            def restore():
                serve_engine.ServingEngine.submit = submit
                server.OpusServer._deliver = deliver
    else:
        argv = pt_argv(tmp, i, out)
        seen, restore = pt_record_training()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    saved_term = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        restore()
        rec.restore()
        signal.signal(signal.SIGTERM, saved_term)
        pt_depth(None)
    torch.cuda.synchronize()
    res.update(counts=read_counts(), wall=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(),
               printed=buf.getvalue(), layout=par_layout())
    if kind != "serve":
        res.update(metrics=seen["metrics"], grads=seen["grads"],
                   stamps=seen.get("stamps", []))
    elif rank == 0:
        firsts = [(a, k, o) for a, k, o in rec.calls.get("prefill_group", [])
                  if k.get("prefix") is None]
        if firsts:
            (a, k, (lg, _)) = firsts[0]
            res.update(logits=lg.cpu(), group_embs=a[2].cpu(),
                       n_valid=a[3].cpu(), bucket=a[4], max_len=k["max_len"],
                       quantize=k["quantize"])
    torch.save(res, os.path.join(tmp, f"pt{i}_rank{rank}.pt"))


def pt_rank(rank, tmp, here, layers):
    """One rank of phase 17: its process group (file rendezvous, the
    backend core.mesh picks), then every run of PT_RUNS through the port's
    CLI. Any exception exits non-zero."""
    import datetime
    import gc
    import traceback
    try:
        sys.path.insert(0, here)
        import torch
        import torch.distributed as dist
        from opus_pllm_tpu_torch.cli import main as cli
        from opus_pllm_tpu_torch.core import mesh as mesh_mod
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh_mod.initialize_distributed(
            "file://" + os.path.join(tmp, "rendezvous"), PT_RANKS, rank,
            device_type="cuda", timeout=datetime.timedelta(
                seconds=PT_TIMEOUT))
        info = mesh_mod.backend_info()
        if rank == 0:
            print(f"parallel training: {PT_RANKS} ranks, backend "
                  f"{info['backend']}, sharing one card: {info['shared']}",
                  flush=True)
        cli.load_tokenizer = lambda path, family: ByteTokenizer()
        for i in range(len(PT_RUNS)):
            pt_one_run(rank, tmp, i, layers)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        print(f"rank {rank}:\n{traceback.format_exc()}", flush=True)
        os._exit(1)


def pt_reference(tmp, i, layers):
    """Run i's command on one process (no mesh flags) -> (its record,
    launch counts, printed lines, seconds)."""
    import gc
    import torch
    pt_depth(layers)
    seen, restore = pt_record_training()
    reset_counts()
    try:
        lines, dt = run_cli(pt_argv(tmp, i, os.path.join(tmp, f"one{i}"),
                                    mesh=False))
    finally:
        restore()
        pt_depth(None)
    counts = read_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return seen, counts, lines, dt


def pt_train_want(i, layers):
    """The launches a step of run i takes on every rank (and on one
    process): the flash forward twice (remat) and each backward once a
    layer, the encoder kernels once an ESM2 layer, the v1 product twice
    for each of the 7 projections a layer, and for the head once, or
    twice a chunk of the chunked cross-entropy (each chunk's head runs
    again in its recompute)."""
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    if PT_RUNS[i][1] == "cstp":
        return {}
    want = {"flash_attention": 2 * layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            **{n: 33 for n in fe.launches}}
    if "--load-int4" in PT_RUNS[i][2]:
        chunk = PT_CE_CHUNK_SHARED if pt_shared() else 0
        heads = 2 * -(-(TRAIN_LEN - 1) // chunk) if chunk else 1
        want["int4_matmul_v1"] = 2 * 7 * layers + heads
    return {n: PT_STEPS * c for n, c in want.items()}


def pt_resumed(tmp, i, layers, step):
    """Run i's command on one process resumed from the mesh's checkpoint
    of `step` - 1, for `step` only -> (its record, its checkpoint
    directory)."""
    import gc
    import shutil
    import torch
    kind = PT_RUNS[i][1]
    d = os.path.join(tmp, f"resumed{i}_{step}")
    shutil.copytree(os.path.join(tmp, f"out{i}", "resume_state",
                                 str(step - 1)),
                    os.path.join(d, "resume_state", str(step - 1)))
    pt_depth(layers if kind == "lora" else None)
    seen, restore = pt_record_training()
    try:
        argv = pt_argv(tmp, i, d, mesh=False)
        argv[argv.index("--max-steps") + 1] = str(step)
        run_cli(argv + ["--resume"])
    finally:
        restore()
        pt_depth(None)
    gc.collect()
    torch.cuda.empty_cache()
    return seen, os.path.join(d, "resume_state")


def pt_train_gates(card, tmp, i, res, layers):
    """Run i against one process (module docstring, phase 17): step 1
    against one process on the same batches, each later step against one
    process resumed from the mesh's checkpoint of the step before (the
    same parameters and moments), the launch counts on every rank; for
    the bf16 run the mesh's checkpoint restored and resumed on one
    process."""
    import math
    import torch
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.train.multimodal_trainer import leaves
    label, kind, flags = PT_RUNS[i]
    seen, counts, lines, dt = pt_reference(tmp, i, layers)
    r0 = res[0]
    expect_counts(f"parallel {label}, one process", counts,
                  **pt_train_want(i, layers))
    for r, rr in enumerate(res):
        expect_counts(f"parallel {label} rank {r}", rr["counts"],
                      **pt_train_want(i, layers))
    lora = kind == "lora"
    rtol = PT_LOSS_RTOL if lora else PT_CSTP_RTOL
    grel = PT_GRAD_RTOL if lora else PT_CSTP_GRAD_RTOL
    lr = PT_LORA_LR if lora else PT_CSTP_LR
    key = "trainable" if lora else "params"
    out = os.path.join(tmp, f"out{i}")
    got_l = [m["loss"] for m in r0["metrics"]]
    want_l = [m["loss"] for m in seen["metrics"]]
    step_s = lambda st: ", ".join(f"{b - a:.3f}" for a, b in zip(st, st[1:]))
    print(f"parallel {label}: losses mesh {got_l} one process {want_l}; "
          f"step {PT_STEPS}'s wall mesh {step_s(r0['stamps'])} s "
          f"({r0['layout']}), one process {step_s(seen['stamps'])} s; "
          f"whole runs {r0['wall']:.1f} / {dt:.1f} s (weights drawn "
          f"included) [{card}]", flush=True)
    if len(got_l) != PT_STEPS or not all(map(math.isfinite, got_l)):
        fail(f"parallel {label}: losses {got_l}")

    def held(step, m, w, g, gw):
        # one step of the mesh against one process on the same parameters
        if abs(m["loss"] - w["loss"]) > rtol * abs(w["loss"]):
            fail(f"parallel {label} step {step}: loss {m['loss']}, one "
                 f"process {w['loss']} (rtol {rtol:.3e})")
        if not lora and (m["grad_norm"] <= 0 or any(
                abs(m[k] - w[k]) > 1e-3 * max(abs(w[k]), 1.0) for k in w)):
            fail(f"parallel {label} step {step}: metrics {m}, one process "
                 f"{w}")
        worst = 0.0
        for a, b in zip(g, gw):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            worst = max(worst, err / max(scale, 1e-30))
            if a.shape != b.shape or err > grel * scale:
                fail(f"parallel {label} step {step}: a gradient leaf "
                     f"{tuple(a.shape)} {err:.3e} from one process's "
                     f"(largest {scale:.3e})")
        return worst
    worst = [held(1, r0["metrics"][0], seen["metrics"][0], r0["grads"][0],
                  seen["grads"][0])]
    # step 1's parameters: Adam's first step moves each entry by lr sign(g),
    # so an entry may move the other way only where one process's gradient
    # lies within the gradient bound of 0
    p1 = [leaves(CheckpointManager(os.path.join(d, "resume_state")).restore(
        step=1)[key]) for d in (out, os.path.join(tmp, f"one{i}"))]
    flips = 0
    for a, b, gw in zip(*p1, seen["grads"][0]):
        flip = (a.float() - b.float()).abs() > lr
        flips += int(flip.sum())
        if flip.any() and (gw.abs()[flip.cpu()] >
                           grel * gw.abs().max()).any():
            fail(f"parallel {label}: step 1 moved an entry the other way "
                 f"where one process's gradient is not within the bound")
    resumed_l, far, dmax, n_all = [], 0, 0.0, 0
    for step in range(2, PT_STEPS + 1):
        rs, rdir = pt_resumed(tmp, i, layers, step)
        resumed_l.append(rs["metrics"][0]["loss"])
        worst.append(held(step, r0["metrics"][step - 1], rs["metrics"][0],
                          r0["grads"][step - 1], rs["grads"][0]))
        # the update from the same state: an entry may differ where the
        # two gradients differ near 0 (Adam's update is about lr sign(g)
        # there), never by more than 2 lr
        got_p, want_p = (leaves(CheckpointManager(d).restore(step=step)[key])
                         for d in (os.path.join(out, "resume_state"), rdir))
        for a, b in zip(got_p, want_p):
            d = (a.float() - b.float()).abs()
            dmax = max(dmax, d.max().item())
            far += int((d > lr / 10).sum())
            n_all += d.numel()
    print(f"parallel {label}: step 1 against one process, steps 2-"
          f"{PT_STEPS} against one process resumed from the mesh's "
          f"checkpoint of the step before (losses {resumed_l}): gradients "
          f"within {', '.join(f'{w:.3e}' for w in worst)} of one process's "
          f"(of each leaf's largest; allowed {grel:.3e}); step 1 moved "
          f"{flips} entries the other way, each where the gradient is "
          f"within that bound of 0; the later updates from the same state "
          f"within {dmax:.3e} (allowed 2 lr = {2 * lr:.3e}), "
          f"{far / max(n_all, 1):.3e} of the entries beyond lr / 10 "
          f"(allowed 1e-2)", flush=True)
    if dmax > 2 * lr or far > 1e-2 * n_all:
        fail(f"parallel {label}: the later updates {dmax:.3e} from one "
             f"process's, {far} of {n_all} entries beyond lr / 10")
    if lora and not all(abs(x - y) <= rtol * abs(y)
                        for x, y in zip(got_l, want_l)):
        # the parameters after step 1 differ only in the flipped entries,
        # whose gradients are near 0: the losses stay within the bound
        fail(f"parallel {label}: losses {got_l}, one process {want_l}")
    gib = lambda v: v / 2 ** 30
    print(f"parallel {label}: peak per rank " + ", ".join(
        f"{gib(rr['peak']):.2f}" for rr in res) + " GiB", flush=True)
    if not (lora and "--load-int4" not in flags):
        return
    # the mesh's checkpoint: the full tree, restored and resumed on one
    # process
    mgr = CheckpointManager(os.path.join(out, "resume_state"))
    saved = mgr.restore()
    final = leaves(CheckpointManager(out).restore())
    same = [bool(torch.equal(a, b)) for a, b in zip(
        leaves(saved["trainable"]), final)]
    if mgr.latest_step() != PT_STEPS or not all(same):
        fail(f"parallel {label}: the mesh's checkpoint of step "
             f"{mgr.latest_step()} holds {sum(same)} of {len(same)} "
             f"leaves of its final tree")
    pt_depth(layers)
    try:
        lines, dt = run_cli(pt_argv(tmp, i, out, mesh=False)
                            + ["--max-steps", str(PT_STEPS + 1),
                               "--resume"])
    finally:
        pt_depth(None)
    if f"resuming from step {PT_STEPS}" not in lines or not any(
            f"at step {PT_STEPS + 1}" in ln for ln in lines):
        fail(f"parallel {label}: one process did not resume the mesh's "
             f"checkpoint: {lines}")
    print(f"parallel {label}: the mesh's checkpoint (step {PT_STEPS}) is "
          f"its final tree bit for bit and one process resumed it to step "
          f"{PT_STEPS + 1} in {dt:.1f} s", flush=True)


def pt_serve_gates(card, tmp, i, res):
    """Run i (serve): every request answered as asked, the ranks' launch
    counts, and the greedy tokens against one process's LLM: the first
    prefill group's logits within phase 3's bound of the fp32 plain path,
    every greedy token within twice that bound of a teacher-forced
    argmax."""
    import torch
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import decoder
    from opus_pllm_tpu_torch.serve.engine import prefill_group
    from opus_pllm_tpu_torch.serve.server import system_prefix_ids
    label = PT_RUNS[i][0]
    r0 = res[0]
    c = r0["client"]
    for line in r0["printed"].splitlines():
        print("   | " + line[:200], flush=True)
    ok = (all("text" in a for a in c.get("greedy", []) + [
              c.get("generate", {}), c.get("sampled", {}),
              c.get("under_b", {})])
          and len(c.get("greedy", [])) == 4
          and "504" in str(c.get("cancelled"))
          and sorted(c.get("adapter", {}).get("adapters", [])) == ["a", "b"]
          and c.get("health", {}).get("total_cancelled") == 1)
    if not ok:
        fail(f"parallel {label}: the client got {c}")
    if "SIGTERM: draining" not in r0["printed"]:
        fail(f"parallel {label}: rank 0 did not drain on SIGTERM")
    # the LLM's kernels alike on every rank; the encoder's on rank 0
    # only, which splices each protein request (33 layers)
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    steps = [rr["counts"] for rr in res]
    llm = [{k: v for k, v in st.items() if k not in fe.launches}
           for st in steps]
    n_prot = len(c["greedy"])
    if any(x != llm[0] for x in llm[1:]) or any(
            steps[0][k] != 33 * n_prot or any(st[k] for st in steps[1:])
            for k in fe.launches):
        fail(f"parallel {label}: launches a rank {steps}")
    print(f"parallel {label}: launches on every rank {llm[0]}, the encoder "
          f"kernels {33 * n_prot} each on rank 0 ({n_prot} proteins "
          f"spliced); 9 requests in {c['wall']:.1f} s ({r0['layout']}) "
          f"[{card}]", flush=True)
    # every prefill runs flash on each rank's heads; int8_matmul runs
    # where an admission group reaches 256 rows (the four annotate
    # requests admitted together), the others take the dequantize route
    if llm[0].get("flash_attention", 0) == 0:
        fail(f"parallel {label}: the kernels did not run: {llm[0]}")
    llm, lcfg = par_single_llm("int8")
    greedy = [(rid, q) for rid, q in r0["requests"].items()
              if q["temperature"] == 0.0 and q["adapter"] is None
              and isinstance(r0["done"].get(rid), list)]
    sys_ids = torch.tensor(system_prefix_ids(ByteTokenizer()),
                           device="cuda")
    tails, outs = [], []
    with torch.no_grad():
        for rid, q in greedy:
            if q["embeds"] is not None:
                e = q["embeds"].cuda()
            else:
                e = decoder.embed_tokens(llm, torch.as_tensor(
                    q["token_ids"], device="cuda").long())
            if q["prefix_id"] == "sys":
                e = torch.cat([decoder.embed_tokens(llm, sys_ids).to(
                    e.dtype), e])
            tails.append(e)
            outs.append(r0["done"][rid])
        fp32 = fp32_llm(llm, lcfg)
        e, nv = r0["group_embs"].cuda(), r0["n_valid"].cuda()
        kw = dict(max_len=r0["max_len"], quantize=r0["quantize"])
        plain = prefill_group(llm, lcfg, e, nv, r0["bucket"], impl="torch",
                              **kw)[0]
        ref = prefill_group(*fp32, e.float(), nv, r0["bucket"],
                            impl="torch", **kw)[0]
        tol = gate(f"parallel {label} prefill logits", r0["logits"].cuda(),
                   plain, ref)
        del fp32
    if len(greedy) < 5:
        fail(f"parallel {label}: {len(greedy)} greedy requests recorded")
    teacher_forced(f"parallel {label}", llm, lcfg, tails, outs,
                   r0["max_len"], 2 * tol)
    del llm


def pt_shard_kernels(card, rows):
    """The training shards' kernels against their plain versions (phase
    3's compare): the flash forward and both backward kernels at a data
    rank's 8 x 519 rows with 16 query and 4 KV heads (M = 2), and
    int4_matmul_v1 at M = 8 x 519 on the projections' shards at M = 2
    (the head's N / 2)."""
    import torch
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    from opus_pllm_tpu_torch.kernels import quant4
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 17)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    b, l, hq, hkv, d = TRAIN_BATCH // 2, TRAIN_LEN, 16, 4, 128
    n_valid = torch.randint(l // 2, l + 1, (b,), generator=g, device="cuda")
    mask = train_mask(n_valid, l)
    pairs = mask.sum().item()
    q, k, v, dout = rnd(b, l, hq, d), rnd(b, l, hkv, d), rnd(b, l, hkv, d), \
        rnd(b, l, hq, d)
    label = f"{b} x {l}, {hq} q / {hkv} kv heads (TP 2)"
    keep(rows, "flash_attention", compare(
        f"flash_attention {label}",
        lambda q, k, v: fa.flash_attention(q, k, v, mask),
        lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
        (q, k, v), card, flops=4 * hq * d * pairs,
        more_bytes=nbytes(mask)), False)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
    delta = fab._delta(out, dout)
    plain = lambda q, k, v, dout: fab.flash_attention_bwd_plain(
        q, k, v, mask, out, lse, dout)
    saved = nbytes(mask, lse, delta)
    keep(rows, "flash_attention_bwd_dq", compare(
        f"flash_attention_bwd_dq {label}",
        lambda q, k, v, dout: fab.flash_attention_bwd_dq(
            q, k, v, mask, lse, delta, dout),
        lambda *a: plain(*a)[0], (q, k, v, dout), card,
        flops=6 * hq * d * pairs, more_bytes=saved, scaled_atol=True), False)
    keep(rows, "flash_attention_bwd_dkv", compare(
        f"flash_attention_bwd_dkv {label}",
        lambda q, k, v, dout: fab.flash_attention_bwd_dkv(
            q, k, v, mask, lse, delta, dout),
        lambda *a: torch.stack(plain(*a)[1:]), (q, k, v, dout), card,
        flops=8 * hq * d * pairs, more_bytes=saved, scaled_atol=True), False)
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    m = b * l
    for kk, n in ((4096, 2048), (4096, 512), (2048, 4096), (4096, 7168),
                  (7168, 4096), (4096, 64128)):
        wq, s = quant4.quantize_grouped(torch.randn(
            (kk, n), generator=g, device="cuda"))
        packed = quant4.pack_int4(wq)
        del wq
        x = rnd(m, kk)
        keep(rows, "int4_matmul_v1", compare(
            f"int4_matmul_v1 M={m} K={kk} N={n} (TP 2)",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
            flops=2 * m * kk * n, more_bytes=nbytes(packed, s)), False)
        del s, packed, x
        torch.cuda.empty_cache()


def check_parallel_training(card, rows):
    """Phase 17 (module docstring): PT_RANKS ranks on this card (or a card
    each) run train-lora / train-cstp on meshes and serve --mesh 1,4
    through the port's CLI; their results are gated against one process
    here."""
    import gc
    import shutil
    import socket
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    t_phase = time.perf_counter()
    # the one process's runs take the byte tokenizer, as the ranks do (no
    # tokenizer files; and no hub lookup, ever)
    os.environ["HF_HUB_OFFLINE"] = "1"
    cli.load_tokenizer = lambda path, family: ByteTokenizer()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="opus-parallel-train-")
    layers = PT_LAYERS_SHARED if pt_shared() else 32
    print(f"parallel training: train-lora at {layers} of Llama-3-8B's 32 "
          f"layers ({'the ranks share one card' if pt_shared() else 'a card a rank'}); serve at 32", flush=True)
    try:
        pt_files(tmp)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with open(os.path.join(tmp, "port"), "w") as f:
            f.write(str(port))
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=pt_rank, args=(r, tmp, here, layers))
                 for r in range(PT_RANKS)]
        for p in procs:
            p.start()
        end = time.monotonic() + PT_TIMEOUT
        while any(p.is_alive() for p in procs) and time.monotonic() < end:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        if codes != [0] * PT_RANKS:
            fail(f"parallel training: rank exit codes {codes} (None: still "
                 f"running after {PT_TIMEOUT} s)")
        print(f"parallel training: {len(PT_RUNS)} runs of {PT_RANKS} ranks, "
              f"every rank exited 0, in {time.perf_counter() - t_phase:.1f} "
              f"s [{card}]", flush=True)
        results = [[torch.load(os.path.join(tmp, f"pt{i}_rank{r}.pt"),
                               weights_only=False) for r in range(PT_RANKS)]
                   for i in range(len(PT_RUNS))]
        for i, (label, kind, _) in enumerate(PT_RUNS):
            if kind == "serve":
                pt_serve_gates(card, tmp, i, results[i])
            else:
                pt_train_gates(card, tmp, i, results[i], layers)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pt_shard_kernels(card, rows)
    torch.cuda.empty_cache()
    print(f"parallel training phase wall {time.perf_counter() - t_phase:.1f}"
          f" s [{card}]", flush=True)


def single_card_baseline(card):
    """Phase 16's run (a) (annotate, bf16 Llama-3-8B, 8 requests, greedy)
    on one process on this card: the baseline of the TP-4 decode step
    phase 16 printed (phase 17 prints its one process's train steps
    beside the mesh's)."""
    import gc
    import shutil
    import tempfile
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    cli.load_tokenizer = lambda path, family: ByteTokenizer()
    tmp = tempfile.mkdtemp(prefix="opus-baseline-")
    try:
        par_examples(tmp)
        rec = Calls()
        rec.wrap(engine, "generate")
        try:
            run_cli(["annotate", "--model-base",
                     os.path.join(tmp, "Meta-Llama-3-8B"), "--test-json",
                     os.path.join(tmp, "par_short_keywords.json"),
                     "--max-new-tokens", str(PAR_NEW), "--temperature",
                     "0", "--batch-size", "8"])
        finally:
            rec.restore()
        (_, _, out), = rec.calls["generate"]
        print(f"single-card baseline, phase 16 run a on one process: decode "
              f"{out.decode_seconds:.2f} s, {out.steps} steps, "
              f"{1e3 * out.decode_seconds / out.steps:.1f} ms a step "
              f"[{card}]", flush=True)
        del rec, out
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    # nothing here reads a tokenizer or a model from a hub
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    t_start = time.perf_counter()
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    for flag in ("--kernel-times", "--flash-times", "--decode-times",
                 "--encoder-times"):
        if flag in sys.argv[1:]:
            kernel_times(flag, sys.argv[sys.argv.index(flag) + 1:]
                         or [os.path.dirname(os.path.abspath(__file__))])
            return
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import opus_pllm_tpu_torch
        from opus_pllm_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the opus_pllm_tpu_torch package is missing beside "
             f"chip_smoke.py ({e})")
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(opus_pllm_tpu_torch.__file__)))
    if pkg_root != here:
        fail(f"opus_pllm_tpu_torch was imported from {pkg_root}, not from "
             f"the checkout beside chip_smoke.py ({here})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"{card}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {len(build.sources())} sources in parallel in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          + ", ".join(f"{n} {t:.1f} s" for n, t in
                      build.build_seconds.items()) + ")", flush=True)
    for line in build.build_log.splitlines():
        if line.startswith("[") or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    if "--profile-serving" in sys.argv[1:]:
        phase("serving profile")
        profile_serving(card)
        return
    if "--profile-training" in sys.argv[1:]:
        phase("training profile")
        profile_training(card)
        return
    if "--parallel" in sys.argv[1:]:
        rows = {}
        phase("parallel (serving)")
        check_parallel(card, rows)
        phase("parallel (training and serve)")
        check_parallel_training(card, rows)
        phase("single-card baseline")
        single_card_baseline(card)
        return

    phase("kernels vs plain")
    rows = check_kernels(card)
    rows.update(check_quant_kernels(card))
    rows.update(check_serve_kernels(card))
    rows.update(check_train_kernels(card))

    phase("slice")
    counts, params, cfg, examples, gen = check_slice(card)

    phase("function metrics")
    check_function_metrics(card, params, cfg, gen)

    phase("mcq")
    check_mcq(card, params, cfg)

    phase("quantized slice")
    qcounts = check_quant_slice(card, params, cfg, examples, gen)

    phase("serving slice")
    scounts = check_serve_slice(card, params, cfg, gen)

    phase("engine options")
    check_engine_options(card, params, cfg, gen)

    phase("server")
    check_server(card, params, cfg)

    phase("training slice")
    tcounts, qlora_counts = check_train_slice(card, params, cfg)

    phase("stage (a)")
    check_stage_a(card, params)

    phase("families")
    check_families(card, params, cfg)
    del params
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    phase("cli")
    check_cli(card)

    phase("loaders")
    check_loaders(card)

    phase("parallel (serving)")
    check_parallel(card, rows)

    phase("parallel (training and serve)")
    check_parallel_training(card, rows)

    kernels = [{"name": n, "route": "cuda", "source": SOURCE,
                "replaces": TPU_KERNELS[n], "launches": counts[n]}
               for n in TPU_KERNELS]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": qcounts["int8" if n.endswith("int8")
                                     else "int4"][n]}
                for n, (tpu, src) in QUANT_KERNELS.items()]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": scounts[n]}
                for n, (tpu, src) in SERVE_KERNELS.items()]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": (qlora_counts if n == "int4_matmul_v1"
                              else tcounts)[n]}
                for n, (tpu, src) in TRAIN_KERNELS.items()]
    for k in kernels:
        k.update({key: rows[k["name"]][key]
                  for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "route_ms")
                  if key in rows[k["name"]]})
    phase("result")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s [{card}]",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
