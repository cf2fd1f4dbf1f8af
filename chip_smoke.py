"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main path's shapes,
drives the separate -> RVC chain, RVC training, Zonos TTS, the speech
engines of the LM core (Dia, XTTS, the LM), Chatterbox, transcription,
multi-take alignment, WaveTransfer, Super Resolution's learned enhancers and
music generation (Stable Audio, ACE-Step, YuE) at full width, loads the
checkpoint formats of the chain, of the listening models, of the speech
engines and of the music models, runs the parallel layer (a data-parallel
training step and a tensor-parallel LM on two ranks sharing the card, the
separator's fan-out) and the host utilities, and checks the output.

    python3 chip_smoke.py                          # every phase, one card
    python3 chip_smoke.py --phases card,kernels    # a subset
    python3 chip_smoke.py --phases card,f0,vr,long # the paths beside the chain
    python3 chip_smoke.py --phases card,serve      # the REST server and main.py
    python3 chip_smoke.py --phases card,separators # HTDemucs, MDX23C, the ONNX member
    python3 chip_smoke.py --phases card,train      # RVC training and its three routes
    python3 chip_smoke.py --phases card,kernels,tts  # Zonos TTS and the speech route
    python3 chip_smoke.py --phases card,kernels,engines  # Dia, XTTS, the LM core, Zonos's
                                                   # embedded prefix, the speech routes
    python3 chip_smoke.py --phases card,processors # Remaster, Super Resolution, Convert,
                                                   # Compare, Clone's OpenVoice and TTS
                                                   # methods, diarization, crepe
    python3 chip_smoke.py --phases card,kernels,chatterbox  # Chatterbox (T3, S3Gen, the
                                                   # S3 tokenizer, CAMPPlus), the
                                                   # wespeaker diarizer, the speech route
    python3 chip_smoke.py --phases card,kernels,transcribe  # Whisper (large-v3 widths),
                                                   # the wav2vec2 aligner, PyanNet, RTLA
                                                   # alignment, the transcription and
                                                   # align routes
    python3 chip_smoke.py --phases card,diffusion  # WaveTransfer (training, resume,
                                                   # generate, BDDM) through its routes,
                                                   # Super Resolution by WaveGrad and by
                                                   # AudioSR at published widths
    python3 chip_smoke.py --phases card,kernels,music  # stable-audio-open's DiT, T5 and
                                                   # Oobleck, the in-repo Stable Audio,
                                                   # ACE-Step, the music routes
    python3 chip_smoke.py --phases card,kernels,lora  # ACE-Step LoRA training (gradients
                                                   # through K1 and K2), the LoRA routes,
                                                   # the checkpoint ACE-Step, CLAP
    python3 chip_smoke.py --phases card,kernels,yue  # YuE's two LM stages and xcodec at
                                                   # YuEConfig(), the YuE routes, the
                                                   # checkpoint path
    python3 chip_smoke.py --phases card,loaders    # the chain's checkpoint formats written
                                                   # in the upstream layouts and loaded
                                                   # onto the card, the chain from them
    python3 chip_smoke.py --phases card,loaders_listen  # Super Resolution, transcription,
                                                   # diarization and alignment from files
    python3 chip_smoke.py --phases card,loaders_speech  # XTTS-v2's model.pth and dvae.pth,
                                                   # Dia and its DAC from files, each
                                                   # engine run against its twin
    python3 chip_smoke.py --phases card,loaders_voice  # Zonos with its prefix bank,
                                                   # OpenVoice and a Chatterbox directory
                                                   # from files, each against its twin
    python3 chip_smoke.py --phases card,loaders_music  # stable-audio-open, the checkpoint
                                                   # ACE-Step's directory, CLAP and Vocos
                                                   # from files, each against its twin
    python3 chip_smoke.py --phases card,parallel   # dp RVC step and tp LM core on two ranks
                                                   # sharing the card, the separator's
                                                   # fan-out, export, the native library,
                                                   # the dry run
    python3 chip_smoke.py --profile DIR            # + profiler tables of one chain pass,
                                                   # of the separator family, of TTS, of
                                                   # a Dia call, an XTTS-v2 synthesize,
                                                   # a Chatterbox clone, a WaveGrad train
                                                   # step and FAST_6, an AudioSR chunk,
                                                   # a full-width YuE generate_music

Phases, one line each (any failure exits non-zero, and no result is printed):

  card       nvidia-smi name and power limit, torch/CUDA versions, build seconds
  kernels    K1 and K2 against their plain versions at the main path's shapes
             (K2 in fp32 and in bf16, at Zonos's causal fp32 prefill, and at
             Dia's causal fp32 prefill with scale 1.0, d = 64 and 128, and its
             BOS-only t = 1 call, at T3's causal fp32 teacher-forced
             forward, at the wav2vec2 aligner's spans of 5-30 s, at
             Whisper's causal uncached decoder forward and at the music DiTs'
             self-attention (fp32 2 x 24 x 1013, bf16 2 x 16 x 1012 and
             2 x 16 x 323, the bf16 ones on the Hopper route); every K2 case timed
             over 200 launches), K1's
             Hopper design against the WMMA core
             on each axis (in turns); the 16-bit K2 on its Hopper design at
             the HuBERT shape, a causal tq != tk shape, a causal language-model
             prefill (16 x 2048 x 128) and a d = 128 shape with ragged keys,
             each against the row-per-thread-group kernel in turns; K3-K7 (off
             the chain) against theirs at the RoFormer's shapes: K3 on the rope
             variant of the Hopper time design against its WMMA core, K7 on
             the packed layout and on a fused qkv's views, K6 and K7 each
             against its WMMA core and against K1's route of the same shape,
             and the three comparisons the TPU probes were written for
  separator  two BS-RoFormer members (dim 512, 12 axial pairs, 8 heads x 64,
             distinct seeded weights) on a 60 s stereo 44.1 kHz track: 8 chunks,
             one device batch; 48 K1 launches, all on the Hopper routes
  rvc        mono mix, 44.1 -> 16 kHz, VoiceConverter.convert at v2-48k with full
             HuBERT, full RMVPE and a 4096 x 768 index; 12 K2 launches
  fidelity   the same RVC input under the fp32 and the bf16 matmul policy:
             mel-L1 < 1e-2 (BASELINE.md's gate, measured as tests/test_fidelity.py),
             held with retrieval off (see phase_fidelity), and printed with
             retrieval on over the random index and over an index of
             well-separated rows (the k-means centres of the track's own
             HuBERT features plus noise) beside each index's tie margin; the policy's
             convolutions against fp64 (stops above 1e-4 of max|y|), and the
             RVC seconds and mel-L1 with them run two other ways
  f0         convert on the separator's vocals with the f0 methods beside rmvpe:
             YIN fused into the conversion (no RMVPE), rmvpe+, and the hybrid
             ["harvest", "rmvpe+"] (harvest on the host, timed apart); 12 K2
             launches a group each
  reference  small inputs at full width, the card against the CPU's plain path
  timing     one warm chain pass: seconds and audio-seconds per second, and two
             more passes for the spread
  vr         the VR karaoke split (vr_split, KARAOKE) on the stereo vocals stem:
             CascadedASPPNet on 4band_v3 and CascadedNet on 1band_sr44100_hl512
             at VRConfig's default widths, window 512; primary + complement
             against the band round trip of the input, one forward on the card
             against the CPU, seconds for the 60 s stem
  serve      the product's entry point: Separate and Clone configured with the
             chain's models, the 60 s track as a WAV through run_chain in the
             process (per-processor seconds) and through the REST server
             (serve_background on the card): request 1 POST /api/v1/process/chain
             with Separate, Clone, Export, Merge (48 K1, all Hopper, 12 K2, one
             *_merged.wav at the input's rate and length, every stage's files),
             request 2 the same file (Separate's cache: 0 K1); then
             ``python -m audiolab_tpu_torch.main`` as a subprocess: GET
             /openapi.json, the DSP split through POST /api/v1/process/separate,
             SIGTERM, exit 0
  separators the rest of the separator family at published widths on the 60 s
             track, each step cold then warm: (a) StemSeparator with the two
             BS-RoFormer members, MDX23C (InstVoc_HQ, 7.2 / 14.9) and an MDX-NET
             ONNX member (dim_f 3072, dim_t 256, n_fft 7680; its graph a
             TFC-TDF U-Net written here by the port's build_model, not a
             published net's): 48 K1, all Hopper, finite stems; (b)
             separate_multistem with HTDemucs (htdemucs_6s): six stems summing
             to the input within 1e-4 of its peak; (c) an MDX23C over DRUM_KIT
             on (b)'s drums; (d) POST /api/v1/process/separate with Separate
             configured with (a)-(c), vocals_only off and the drum split on:
             HTTP 200, the JAX processor's 13 WAVs; (e) one 8 s chunk through
             HTDemucs, MDX23C and the ONNX runner on the card against the CPU
             in fp32 (1e-4 of max|y|); (f) seconds and peak memory
  processors the rest of the processor registry on the 60 s track at published widths,
             each step cold then warm with its seconds, peak memory and launches:
             (a) Remaster (against the source) -> Convert -> Compare of the
             separated instrumental; Super Resolution 44.1 -> 48 kHz, 7 chunks of
             10.24 s, tgt_ensemble off and on; (b) Clone by OpenVoice
             (ToneColorConfig(): inter/hidden 192, gin 256, decoder 512, rates 8,
             8, 2, 2) on the vocals at 22.05 kHz with a 10 s reference; (c) Clone
             by TTS through the facade's ZonosTTS (ZonosConfig(), Mamba1, three
             sentences: 2 fp32 K2); (d) Clone by OpenVoice with diarize_speakers
             (k-means over the Zonos SpeakerEncoder); (e) VoiceConverter.convert
             with crepe and mangio-crepe (Crepe("full")) and their -tiny methods
             (Crepe("tiny")): 12 K2 each; (f) POST /api/v1/process/chain with
             Separate, Clone (OpenVoice), Remaster, Super Resolution, Convert,
             Compare: 48 K1 (all Hopper), no K2; (g) card against CPU in fp32:
             OpenVoice's waveform, both Crepes' salience, match_spectrum,
             sbr_enhance and NeuralDiarizer's activities
  long       bench.py's 4-minute track through separate -> mono -> resample ->
             convert, once after a pass that warms its shapes: 32 chunks in 4
             groups of 8, 192 K1 launches (all Hopper), 48 K2, stage seconds
  train      RVC training: (a) the GAN train step at v2-48k with the full
             multi-period discriminator, batch 8 of 3.7 s (366 frames, segment
             17280) on a seeded harmonic batch: cold step, 15 warm steps
             (median, min, max), the six losses, peak memory, loss_mel falling,
             no kernel launched; (b) one fp32 step against the same step in
             fp64: the tiny configuration on the card and on the CPU against
             the CPU's, v2-48k at batch 1 on the card against the card's, the
             reference's leaky ReLU sides and excitation phase replayed:
             metrics to 1e-4 relative, each gradient tensor to
             1e-4 of its own max|g|, a bias of the larger of its own and its
             layer weight's (audiolab_tpu_torch/train/check.py); (c) POST /api/v1/rvc/train on 3 x 10 s of
             seeded tones (full HuBERT, full synthesizer and discriminator,
             batch 4, 2 epochs; 12 fp32 K2 a feature group), /rvc/resume to 3
             epochs (one epoch's steps more), /rvc/build_index, and the
             trained .npz converting 10 s through a VoiceConverter, with each
             job's stage seconds

  tts        Zonos TTS at the published backbone widths (dim 1024, 12 layers,
             attention every 6th, 16 x 64 heads, 9 codebooks) with the 44.1 kHz
             DAC (decoder_dim 1536), both mixers (mamba1, mamba2): (a)
             ZonosTTS.synthesize on three sentences with an emotion tag (CFG
             batch 6), cold and 2 warm (each captures its decode step): 2
             fp32 K2 launches a call and nothing else, seconds of prefill,
             decode and DAC, steps/s, audio-s/s, peak memory; (b) the captured
             decode against the eager loop under the same draws (identical
             codes), the DAC on 50 of those frames against a CPU copy (1e-5
             of max|y|), the card's fp32 logits against the CPU's over
             prefill and 8 teacher-forced steps (1e-4 of max|logit|); (c) POST
             /api/v1/audio/speech through create_app: a 44.1 kHz WAV, the
             download, 2 K2
  engines    the LM core's speech engines, each call cold then warm with its
             seconds by stage, steps/s and peak memory: (a) Dia at DiaConfig()
             through DiaTTSEngine and the 44.1 kHz DAC on a two-speaker line of
             27 words: 12 fp32 K2 a call, the captured decode against the eager
             loop, the code-range repair; (b) Dia with a 5 s audio prompt
             (prefill 441 positions) at DiaConfig() and at Dia-1.6B's decoder
             geometry (18 fp32 K2, d = 128), and a teacher-forced forward; (c)
             the capability XTTS at XTTSConfig() and random_xtts(); (d)
             XTTS-v2 at its published widths: conditioning on 6 s, 200 decode
             steps, the cached decode against a full re-forward; (e) Zonos
             generate_embedded from the prefix bank (2 fp32 K2); (f)
             TransformerLM at LMConfig(), bf16, one uncached forward over 2,048
             tokens (16 K2 on the Hopper route); (g) POST /api/v1/audio/speech
             with "dia" and "coqui", and main --demo-backends answering
             "coqui"; (h) card against CPU in fp32 (1e-5 of the scale): Dia's
             logits, XTTS-v2's latents and waveform, the prefix conditioner
  chatterbox Chatterbox at its published widths (T3 30 x 1024 fp32, S3Gen's flow
             and HiFT, the S3 tokenizer 12 x 1280, CAMPPlus, the voice encoder):
             (a) cloning from a 6 s reference, synthesize with max_tokens 200,
             cold and 2 warm, seconds by stage, steps/s, audio-s/s, peak memory,
             no kernel launched; the captured decode against the eager loop;
             (b) T3's teacher-forced forward over (a)'s context and tokens: 30
             fp32 K2 (the path's launches), the cached decode's logits within
             1e-5 of it; (c) the builtin voice and random_chatterbox(); (d)
             NeuralDiarizer with the WeSpeaker ResNet34 back end on 30 s of two
             speakers; (e) POST /api/v1/audio/speech with "chatterbox" and main
             --demo-backends answering it; (f) card against CPU in fp32 (1e-5 of
             the scale): T3's logits, the flow's mel, HiFT's waveform, the
             x-vector, the WeSpeaker embedding, the kaldi fbank; the S3 ids equal
  transcribe Whisper at large-v3's dimensions (128 mels, 32 + 32 layers of 1280,
             20 heads, 51,866 tokens) on 60 s: the encoder, the captured decode
             of 64 tokens against the eager loop (identical tokens), steps/s,
             the uncached forward (32 fp32 K2) against the cached decode,
             card against CPU at 2 + 2 layers; the CTC aligner at
             wav2vec2-base-960h's widths on spans of 5, 10, 20 and 30 s (12 fp32
             K2 each, cold and warm, spans identical on the card and the CPU);
             PyanNet's VAD on 60 s and the diarizer's PyanNet back end on 30 s;
             align_take of 30 s onto 30 s with chroma and with RtlaCRNN; POST
             /api/v1/audio/transcriptions and /api/v1/align, and main
             --demo-backends answering "whisper"
  diffusion  WaveTransfer and Super Resolution's learned enhancers, fp32 with
             TF32 off: (a) WaveGrad at WTConfig() (24 kHz, 128 mels, hop
             300, batch 8 of 7,200 samples) through POST
             /api/v1/wavetransfer/train (20 steps on 2 x 10 s, polled to
             done, first and warm step seconds), a resume to 30 steps,
             /wavetransfer/generate on 30 s with fast6 and fast12, 10 BDDM
             schedule-net steps and the schedule search, one chunk's FAST_6
             sample card against CPU; (b) train_superres for 5 steps at 48
             kHz, load_enhancer, POST /api/v1/process/super_resolution on 20 s
             of stereo, cold and warm; (c) AudioSR (VAE, UNet and vocoder at
             the published widths) enhance_chunks on one 10.24 s stereo
             chunk, 50 DDIM steps at guidance 3.5, cold and warm with peak
             memory, the UNet and one guided DDIM step card against CPU, the
             Super Resolution route with ckpt_pipeline on 20 s of stereo; no
             kernel launched
  music      the DiT family at published widths, cut only in sampler steps: (a)
             StableAudioCheckpointPipeline at stable-audio-open-1.0's geometry
             (SAO DiT 1536 x 24, fp32; T5-base; the Oobleck decoder) on 47 s,
             DPM++ 3M SDE, 8 of 100 steps (24 fp32 K2 a guided step); (b) the
             in-repo Stable Audio (DiT 1024 x 16, bf16) generate_audio on 47 s,
             8 of 50 steps (16 K2 a step on the Hopper route); (c) ACE-Step at
             ACEStepConfig() generate on 30 s at its 27 steps and a repaint;
             each cold and warm with seconds, peak memory, launches and a
             guided step's milliseconds; (d) POST /api/v1/audio/generate and
             /api/v1/acestep/generate; (e) card against CPU at 2 layers of
             each DiT: a forward and one sampler step
  lora       ACE-Step's LoRA and checkpoint model, CLAP: (a) train_lora at
             ACEStepConfig() (DiT 1024 x 16, bf16) with LoRATrainConfig()
             (rank 8, batch 2, 32 frames) on two 10 s clips, 6 of 200 steps
             (16 K1 a step; the backward is the plain version's gradient and
             launches none), and 3 steps with the SSL loss on HuBERT; (b) the
             b gradients of wq/wk/wv through K1 (32 frames) and the 16-bit K2
             (200 frames) against the plain version's; (c) POST
             /api/v1/acestep/lora/train (polled to done) and lora/generate with
             the adapter, the base generate unchanged around it; (d)
             CheckpointACEStep at the JAX widths (DiT 1536 x 28, fp32, the
             lyric conformer, UMT5-base, MusicDCAE on AutoencoderDC and ADaMoS)
             on 30 s, 8 of 60 steps, no kernel launched; (e) CLAP's branches,
             card against CPU; (f) card against CPU at 2 layers: the
             checkpoint DiT, the DCAE round trip, ADaMoS, one LoRA step's
             gradients.  Phase kernels adds K1's and K2's forward + backward
             at (b)'s shapes
  yue        YuE: (a) random_yue (2 + 2 layers, fp32) with captured steps on the
             card against a CPU copy under the same draws (identical codes,
             audio to 1e-5 of max|y|), XCodecConfig()'s decoder card against
             CPU; (b) YuEConfig() (stage 1 2048 x 16 bf16, stage 2 1024 x 8,
             83,734 ids) with XCodecConfig() on one 512-frame segment at CFG
             1.5, top-p 0.93, repetition penalty 1.2: stage 1's prefill and
             captured steps/s against 32 eager frames (identical codes), stage
             2's blocks and steps/s, the xcodec decode, generate_music cold and
             warm with peak memory; no kernel launched (both stages prefill
             through the static cache); (c) POST /api/v1/yue/generate and GET
             /api/v1/yue/stream/{file_id}; (d) a 2 + 2-layer stack at the
             published widths written in the upstream layout (sharded bf16
             safetensors, the xcodec .pth with weight-norm pairs, a
             tokenizer.model) and loaded by load_yue_pipeline onto the card:
             the same weights and codes as the pipeline it was written from
  loaders    the checkpoint formats of the Separate -> Clone chain at full width,
             written from seeded modules in the upstream containers and names
             (two BS-RoFormer .ckpt under state_dict with Lightning's model.,
             fairseq's hubert_base.pt with pos_conv's weight-norm pair, rmvpe.pt,
             process_ckpt's v2-48k .pth in fp16 with weight-norm pairs,
             torchcrepe's full.pth, htdemucs_6s, MDX23C InstVoc_HQ under ZFTurbo's
             names, both VR nets; batch norms and recurrent biases drawn off
             their initial values) and read by the port's loaders onto the
             card: every tensor equal to its module's with the loader's folds
             applied, each folded net (RMVPE's BiGRU, the VR nets) in fp64
             within 1e-5 of max|y| of the net it was written from, each file's
             MiB, write and load seconds; the 60 s chain from the loaded files
             (48 K1, all Hopper, 12 K2) against the chain in memory (1e-6 of
             max|y|); HTDemucs, MDX23C and the VR nets from their files on 10 s
             against theirs
  loaders_speech  the speech engines' formats at full width, written from the
             seeded modules of phase engines in the upstream containers and
             names (XTTS-v2's model.pth with its five parts under Coqui's
             prefixes, the HiFi decoder's weight-norm pairs with their gains
             drawn off, the speaker encoder's batch norms off their initial
             values; dvae.pth; Dia at DiaConfig() and at Dia-1.6B's decoder
             geometry as .safetensors; the DAC's weights.pth with its encoder)
             and read by the port's loaders onto the card: every tensor equal
             to its twin's, each file's MiB, write and load seconds;
             XttsCheckpointEngine's conditioning and 200 synthesize steps, the
             DVAE, DiaTTSEngine on the 27-word line (12 K2) and Dia-1.6B's
             teacher-forced forward (18 K2) from the files, each bit-equal to
             its twin's with equal launches
  loaders_voice  the rest of the speech and cloning formats at full width:
             Zonos at ZonosConfig(mixer="mamba2") with the published prefix
             bank (mlp projection, its specs read back from a written
             config.json) in one model.safetensors, OpenVoice's converter.pth
             at ToneColorConfig() (weight-norm gains and GRU biases drawn off),
             and a Chatterbox directory (t3_cfg, ve and s3gen .safetensors with
             CAMPPlus and the S3 tokenizer bundled, tokenizer.json, conds.pt)
             read by load_chatterbox_pipeline: every tensor equal to its
             twin's, each file's MiB, write and load (or read) seconds;
             generate_embedded (2 K2) and ZonosTTS.synthesize (2 K2), the
             OpenVoice conversion, Chatterbox's synthesize from the builtin
             voice and cloned from 6 s (on cuDNN's deterministic algorithms,
             beside the twin's run-to-run spread under the default ones) and
             T3's teacher-forced forward (30 K2) from the files, each
             bit-equal to its twin's with equal launches
  loaders_music  the music models' formats at the published widths, each
             weight-norm gain drawn off: stable-audio-open's model.safetensors
             (the DiT, the Oobleck decoder's pairs, both seconds embedders)
             with T5-base's file, read by load_stable_audio_pipeline; ACE-Step's
             directory (the transformer with its lyric encoder, the DCAE with
             its config.json, ADaMoS's pairs, UMT5-base), read by
             load_acestep_pipeline; one laion_clap file read by both CLAP
             loaders; Vocos's pytorch_model.bin, its configuration read from
             it: every tensor equal to its twin's, each file's MiB, write and
             read seconds; stable-audio-open's generate on 47 s (192 K2), the
             ACE-Step generate on 30 s, CLAP's embeddings and a Vocos decode
             from the files, each bit-equal to its twin's with equal launches
             (on cuDNN's deterministic algorithms where the twin does not
             repeat on the default ones, with the spread printed)
  parallel   the parallel layer and the host utilities: init_distributed as one
             NCCL rank; the RVC GAN step at v2-48k, batch 8 split 4 + 4 with
             the shards' lengths 366 and 300 frames, on two ranks sharing the
             card over gloo, against the single-process step (step 1's
             metrics, gradients and parameters, later metrics, seconds a
             step); the LM core at YuE's stage-1 geometry under tp 2 on a
             512-token prompt in the same ranks against the replicated and
             fp32 forwards (16 K2 a rank, a profiler trace of rank 0's warm
             forward naming k2h_kernel); StemSeparator(mesh=) with dp 2 in
             the same ranks on the chain's members and the 60 s track (48
             K1 a rank); the v2-48k synthesizer exported and reloaded
             against eager infer; the native library built where the
             script runs, against numpy (the WAV decode timed against the
             numpy decoder); the dry run's four bodies on two gloo ranks

The last lines are the kernels JSON, the card's name and power limit, and
the device JSON.  Weights are random, seeded and filled by bench.py's rules
(audiolab_tpu_torch/utils/fast_init.py; training starts from torch's default
initialisers drawn from a seed); widths are the published ones.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PHASES = ("card", "kernels", "separator", "rvc", "fidelity", "f0", "reference", "timing", "vr",
          "serve", "separators", "processors", "long", "train", "tts", "engines", "chatterbox",
          "transcribe", "diffusion", "music", "lora", "yue", "loaders", "loaders_listen",
          "loaders_speech", "loaders_voice", "loaders_music", "parallel")
SEP_SR, RVC_SR = 44100, 16000
DUR_S = 60.0
LONG_S = 240.0     # bench.py's 4-minute track
HUBERT_LAYERS = 12
# blend weights of the first two members of the reference's ensemble table
MEMBER_WEIGHTS = ((8.6, 16.0), (8.4, 16.0))
SEP_CFG = dict(dim=512, depth=12, heads=8, stems=("vocals",), residual_stem="other")
MEL_L1_GATE = 1e-2

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  Bounds are computed from these and this run's shapes.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exponentials a second on the SFUs (MUFU), as the FlashAttention-3 paper
# gives it for H100 SXM
PEAK_EXP = 3.9e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    """One line for a ``-Xptxas -v`` report: kernels compiled, the range of
    registers a thread, and the kernels that spill (the full report stays
    beside the library)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", report)]
    spilled = [n for n in spills if n]
    return (f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{len(spilled)} spill (at most {max(spilled, default=0)} bytes stored)")


def ptxas_kernels(report: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers a thread, spill-store bytes) of each entry
    in a ``-Xptxas -v`` report."""
    out = []
    for part in report.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0))
    return out


# setmaxnreg hands the producer warpgroup's registers to the two consumer
# warpgroups (168 -> 40 and 168 -> 232 a thread), which needs the launch to
# hold 384 x 168 registers: the __launch_bounds__(384, 1) maximum
K1H_LAUNCH_REGS = 168


def check_new_kernels(report: str) -> None:
    """One line per kernel of this design (the Hopper routes of K1, K3, K6
    and K7, all ``k1h_`` kernels, K2's Hopper kernel ``k2h_`` and its fp32
    kernel) with its registers and spills; raises before any launch if a
    ``k1h_`` or ``k2h_`` kernel would start with fewer registers than
    setmaxnreg hands out, or if ptxas serialised a kernel's wgmma (C7515)."""
    for name, regs, spill in ptxas_kernels(report):
        if not any(tag in name for tag in ("k1h_", "k2h_", "k2f_")):
            continue
        log(f"[card] ptxas {name}: {regs} registers, {spill} bytes spill stores")
        if "k1h_" in name or "k2h_" in name:
            expect(regs == K1H_LAUNCH_REGS,
                   f"{name}: {regs} registers at launch, setmaxnreg needs {K1H_LAUNCH_REGS}")
    expect("C7515" not in report, "ptxas serialised a kernel's wgmma instructions (C7515)")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels

def attention_work(q, k, causal: bool) -> tuple[float, float, float]:
    """(FLOPs, bytes, exponentials) one attention call needs: 4*d FLOPs and
    one exponential per unmasked (query, key) pair; q, k, v read once and o
    written once."""
    bh = q.shape[0] * q.shape[1]
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    if causal:
        rows = np.arange(tq)
        pairs = float(np.clip(rows + (tk - tq) + 1, 0, tk).sum())
    else:
        pairs = float(tq * tk)
    flops = 4.0 * bh * pairs * d
    nbytes = float((2 * q.numel() + 2 * k.numel()) * q.element_size())
    return flops, nbytes, float(bh * pairs)


def with_grad(fn, grad_out):
    """``fn``'s (dq, dk, dv), flattened into one tensor, for ``grad_out``."""
    import torch

    def call(q, k, v):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        grads = torch.autograd.grad(fn(*leaves), leaves, grad_out)
        return torch.cat([g.flatten() for g in grads])

    return call


def norm_work(x, params) -> tuple[float, float]:
    """(FLOPs, bytes) of one RMS/LayerNorm call: about 4 fp32 operations per
    element (5 with a bias); x read once, the output written once, the fp32
    parameters read once."""
    flops = float(x.numel() * (3 + len(params)))
    nbytes = float(2 * x.numel() * x.element_size() + sum(4 * p.numel() for p in params))
    return flops, nbytes


def check_kernel(name, kernel_fn, plain_fn, library_fn, args, shape, tol_rel, tol_reason,
                 work, peak, replaces, source="audiolab_tpu_torch/csrc/attention.cu",
                 library_note=None, iters: int = 10):
    """Holds ``kernel_fn(*args)`` against ``plain_fn(*args)`` and times both and
    the library yardstick (``library_fn`` None: there is no single call) with
    CUDA events over ``iters`` launches (many for calls under 0.1 ms, whose
    single readings are the host's)."""
    import torch

    out = kernel_fn(*args)
    torch.cuda.synchronize()
    ref = plain_fn(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tol_rel[0] * ref.float().abs().max().item() + tol_rel[1]
    finite = bool(torch.isfinite(out).all())
    del out, ref
    # three warm-up calls: the first kernel timed after the build ran ~15 %
    # slow after a single one (the card still ramping its clocks)
    ms = cuda_ms(lambda: kernel_fn(*args), iters=iters, warmup=3)
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters=2)
    library_ms = (None if library_fn is None
                  else cuda_ms(lambda: library_fn(*args), iters=iters))
    torch.cuda.empty_cache()
    flops, nbytes, exps = (*work, 0.0)[:3]
    t_ops, t_bytes, t_exp = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3, exps / PEAK_EXP * 1e3
    rec = dict(name=name, route="cuda", source=source, replaces=replaces, shape=shape,
               max_abs_err=err, tol=tol, tol_reason=tol_reason, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes, t_exp),
               bound_by="operations" if max(t_ops, t_exp) >= t_bytes else "bytes",
               bound_parts_ms=dict(products=t_ops, exponentials=t_exp, bytes=t_bytes),
               flops=flops, bytes=nbytes, exponentials=exps, iters=iters)
    ok = finite and err <= tol
    lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"[kernels] {name} {shape} err {err:.3e} (tol {tol:.3e}: "
        f"{tol_reason}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library {lib_txt}{f' ({library_note})' if library_note else ''} "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: products {t_ops:.3f}, "
        f"exponentials {t_exp:.3f}, bytes {t_bytes:.3f}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: err {err} > tol {tol} or non-finite")
    return rec


def attention_shape(q, k, causal):
    return dict(q=list(q.shape), k=list(k.shape), dtype=str(q.dtype), causal=causal)


def compare(label: str, fns: dict, card: str) -> dict[str, float]:
    """Times two ways to the same result in turns (a, b, b, a), prints and
    returns the means; a comparison held against nothing."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(cuda_ms(fns[n], iters=10))
    txt = ", ".join(f"{n} {np.mean(runs[n]):.3f} ms ({' / '.join(f'{r:.3f}' for r in runs[n])})"
                    for n in names)
    log(f"[kernels] compare {label}: {txt} | {card}")
    return {n: float(np.mean(runs[n])) for n in names}


def phase_kernels(dev, card: str) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def sdpa(causal, scale=None):
        # yardstick only: the port never calls it
        def call(q, k, v):
            tq, tk = q.shape[2], k.shape[2]
            if causal and tq == tk:     # its fused causal kernel takes no offset
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
            mask = None
            if causal:
                mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        return call

    def hopper_launches(fn, wrapper):
        before = wrapper.sm90_launches
        fn()
        return wrapper.sm90_launches - before

    k1_rep = "audiolab_tpu/kernels/attention.py:206"
    k2_rep = "audiolab_tpu/kernels/attention.py:56"
    bf = torch.bfloat16
    k1_tol = ((2.0 ** -6, 0.0), "2 bf16 ulps of max|out|: summation order may flip "
              "an output and a few probability roundings")
    k2_tol = ((0.0, 2e-5), "fp32 sums over <=512 keys in another order")
    norm_tol = ((2.0 ** -7, 0.0), "1 bf16 ulp of max|out|: fp32 row sums in another "
                "order may flip one output's rounding")
    scale = 1.0 / 8.0
    recs = []
    # (label, case, kernel, q shape, k shape, dtype, causal, on the main path)
    cases = [
        ("K1 attention_nk1 (RoFormer time axis)", "k1_time", "K1",
         (496, 8, 690, 64), (496, 8, 690, 64), bf, False, True),
        ("K1 attention_nk1 (RoFormer band axis)", "k1_band", "K1",
         (5520, 8, 62, 64), (5520, 8, 62, 64), bf, False, True),
        ("K2 flash_attention_fwd (HuBERT)", "k2_hubert", "K2",
         (8, 12, 399, 64), (8, 12, 399, 64), torch.float32, False, True),
        # the training dataset's HuBERT: groups of 8 slices of 3.7 s, and a
        # last group of one
        ("K2 flash_attention_fwd (HuBERT, training features)", "k2_train_features", "K2",
         (8, 12, 184, 64), (8, 12, 184, 64), torch.float32, False, True),
        ("K2 flash_attention_fwd (HuBERT, training features, last group)",
         "k2_train_features_1", "K2",
         (1, 12, 184, 64), (1, 12, 184, 64), torch.float32, False, True),
        # Zonos's prefill: CFG batch 6 x 16 heads, 256 text + 4 conditioning
        # + 1 BOS positions, fp32, causal (2 calls a synthesize)
        ("K2 flash_attention_fwd (Zonos prefill, causal)", "k2_zonos_prefill", "K2",
         (6, 16, 261, 64), (6, 16, 261, 64), torch.float32, True, True),
        ("K2 flash_attention_fwd (causal, tq != tk)", "k2_causal", "K2",
         (2, 8, 100, 64), (2, 8, 333, 64), torch.float32, True, False),
        ("K2 flash_attention_fwd (HuBERT shape, bf16)", "k2_hubert_bf16", "K2",
         (8, 12, 399, 64), (8, 12, 399, 64), bf, False, False),
        ("K2 flash_attention_fwd (causal, tq != tk, bf16)", "k2_causal_bf16", "K2",
         (2, 8, 100, 64), (2, 8, 333, 64), bf, True, False),
        # the width and a prefill length of the JAX package's language model
        ("K2 flash_attention_fwd (causal LM prefill, d = 128, bf16)", "k2_lm_prefill_bf16", "K2",
         (1, 16, 2048, 128), (1, 16, 2048, 128), bf, True, False),
        ("K2 flash_attention_fwd (d = 128, ragged keys, bf16)", "k2_d128_ragged_bf16", "K2",
         (2, 16, 1000, 128), (2, 16, 1537, 128), bf, False, False),
    ]
    for label, key, kern, qs, ks, dt, causal, main in cases:
        q, k, v = rnd(qs, dt), rnd(ks, dt), rnd(ks, dt)
        if kern == "K1":
            rec = check_kernel(
                label, lambda q, k, v: A.attention_nk1(q, k, v),
                lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
                sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
                attention_work(q, k, False), PEAK_BF16, k1_rep)
            route = A.k1_route(qs[0] * qs[1], qs[2], ks[2], qs[3], dt)
            expect(route in ("band", "time"), f"{label}: routed to {route}")
            # the WMMA core through its own entry, as a yardstick only
            means = compare(f"K1 Hopper {route} route vs WMMA core ({key})", {
                "hopper": lambda: A.attention_nk1(q, k, v),
                "core": lambda: A.attention_nk1_core(q, k, v),
            }, card)
            rec.update(k1_route=route, core_ms=means["core"], compare_hopper_ms=means["hopper"])
        else:
            rec = check_kernel(
                label, lambda q, k, v, c=causal: A.flash_attention_fwd(q, k, v, causal=c),
                lambda q, k, v, c=causal: A.flash_attention_reference(q, k, v, c,
                                                                      q.shape[-1] ** -0.5),
                sdpa(causal), (q, k, v), attention_shape(q, k, causal),
                *(k2_tol if dt == torch.float32 else k1_tol),
                attention_work(q, k, causal), PEAK_FP32 if dt == torch.float32 else PEAK_BF16,
                k2_rep, iters=200)
            if dt != torch.float32:
                route = A.k2_route(qs[0] * qs[1], qs[2], ks[2], qs[3], dt, causal, True)
                expect(route == "sm90", f"{label}: routed to {route}")
                expect(hopper_launches(lambda: A.flash_attention_fwd(q, k, v, causal=causal),
                                       A.flash_attention_fwd) == 1,
                       f"{label}: the launch was not on the Hopper design")
                # the row-per-thread-group kernel through its own entry, as a yardstick only
                means = compare(f"K2 Hopper design vs row-per-thread-group kernel ({key})", {
                    "hopper": lambda: A.flash_attention_fwd(q, k, v, causal=causal),
                    "core": lambda: A.flash_attention_fwd_core(q, k, v, causal=causal),
                }, card)
                rec.update(k2_route=route, core_ms=means["core"],
                           compare_hopper_ms=means["hopper"])
        rec.update(case=key, kernel=kern, on_main_path=main)
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()

    # Dia's decoder prefill: fp32, causal, scale 1.0, CFG batch 2 x 16 query
    # heads; d = 64 at DiaConfig(), d = 128 at Dia-1.6B's decoder geometry,
    # both over a 5 s audio prompt (441 positions), and the BOS-only t = 1
    # call.  q and k have the spread fast_init's weights give (N(0, 0.02)
    # kernels over a unit-RMS input: std 0.02 sqrt(dim_dec)), so the unscaled
    # scores have a std of 3.3 (d = 64) and 9.3 (d = 128).
    k2_dia_tol = ((4e-5, 0.0), "fp32 scores up to ~50 (scale 1.0) summed in another "
                  "order: 1e-6 on a score moves the output by up to 4e-5 of its max")
    for label, key, qs, dim_dec in (
            ("K2 flash_attention_fwd (Dia prefill, causal, scale 1.0)", "k2_dia_prefill",
             (2, 16, 441, 64), 1024),
            ("K2 flash_attention_fwd (Dia-1.6B prefill, causal, scale 1.0, d = 128)",
             "k2_dia16_prefill", (2, 16, 441, 128), 2048),
            ("K2 flash_attention_fwd (Dia BOS-only prefill, t = 1, scale 1.0)", "k2_dia_bos",
             (2, 16, 1, 64), 1024)):
        sd = 0.02 * dim_dec ** 0.5
        q, k, v = (sd * rnd(qs, torch.float32) for _ in range(3))
        rec = check_kernel(
            label, lambda q, k, v: A.flash_attention_fwd(q, k, v, causal=True, scale=1.0),
            lambda q, k, v: A.flash_attention_reference(q, k, v, True, 1.0),
            sdpa(True, 1.0), (q, k, v), attention_shape(q, k, True) | {"scale": 1.0},
            *k2_dia_tol, attention_work(q, k, True), PEAK_FP32, k2_rep, iters=200)
        expect(hopper_launches(lambda: A.flash_attention_fwd(q, k, v, causal=True, scale=1.0),
                               A.flash_attention_fwd) == 0,
               f"{label}: an fp32 call reached the 16-bit Hopper kernel")
        rec.update(case=key, kernel="K2", on_main_path=False, on_engines_path=True)
        recs.append(rec)
        del q, k, v
    # T3's teacher-forced forward (phase chatterbox (b)): fp32, causal, d = 64,
    # 16 heads over a cloned call's context and its 200 tokens; q and k with
    # fast_init's spread at dim 1024 (std 0.02 sqrt(1024))
    t3_rows = cb_forward_len()
    q, k, v = (0.64 * rnd((1, 16, t3_rows, 64), torch.float32) for _ in range(3))
    rec = check_kernel(
        "K2 flash_attention_fwd (T3 teacher-forced forward, causal)",
        lambda q, k, v: A.flash_attention_fwd(q, k, v, causal=True),
        lambda q, k, v: A.flash_attention_reference(q, k, v, True, 0.125),
        sdpa(True), (q, k, v), attention_shape(q, k, True), *k2_tol,
        attention_work(q, k, True), PEAK_FP32, k2_rep, iters=200)
    expect(A.k2_route(16, t3_rows, t3_rows, 64, torch.float32, True, True) == "core"
           and hopper_launches(lambda: A.flash_attention_fwd(q, k, v, causal=True),
                               A.flash_attention_fwd) == 0,
           "T3's fp32 K2 is not on the register-tiled fp32 kernel")
    rec.update(case="k2_t3_forward", kernel="K2", on_main_path=False,
               on_chatterbox_path=True)
    recs.append(rec)
    del q, k, v
    # the transcribe path: the wav2vec2 aligner's 12 layers (fp32, not causal,
    # 12 heads of 64) over spans of 5, 10, 20 and 30 s, and Whisper's uncached
    # decoder forward at large-v3 (fp32, causal, 2 windows x 20 heads, 64
    # tokens); q and k with fast_init's spread (std 0.02 sqrt(dim))
    k2_span_tol = ((0.0, 2e-5), "fp32 sums over up to 1,499 keys in another order")
    for label, key, qs, causal, sd in (
            *((f"K2 flash_attention_fwd (wav2vec2 aligner, {s:g} s span)",
               f"k2_w2v_{s:g}s", (1, 12, hubert_frames(s), 64), False, 0.55)
              for s in TR_SPANS),
            ("K2 flash_attention_fwd (Whisper uncached decoder forward, causal)",
             "k2_whisper_forward", (2, 20, TR_TOKENS, 64), True, 0.72)):
        q, k, v = (sd * rnd(qs, torch.float32) for _ in range(3))
        rec = check_kernel(
            label, lambda q, k, v, c=causal: A.flash_attention_fwd(q, k, v, causal=c),
            lambda q, k, v, c=causal: A.flash_attention_reference(q, k, v, c, 0.125),
            sdpa(causal), (q, k, v), attention_shape(q, k, causal), *k2_span_tol,
            attention_work(q, k, causal), PEAK_FP32, k2_rep, iters=200)
        rec.update(case=key, kernel="K2", on_main_path=False, on_transcribe_path=True)
        recs.append(rec)
        del q, k, v
    # the music path: the DiT family's self-attention at its published
    # widths (d = 64, not causal): stable-audio-open's fp32 DiT at 47 s (CFG
    # batch 2 x 24 heads over 1,012 latents and the prepended global token),
    # the in-repo Stable Audio DiT at 47 s and ACE-Step's at 30 s (bf16, CFG
    # batch 2 x 16 heads); q and k with fast_init's spread (std 0.02 sqrt(dim))
    k2_music_tol = ((0.0, 2e-5), "fp32 sums over 1,013 keys in another order")
    for label, key, qs, dt, sd in (
            ("K2 flash_attention_fwd (stable-audio-open DiT, 47 s, fp32)", "k2_sao_dit",
             (2, 24, 1013, 64), torch.float32, 0.78),
            ("K2 flash_attention_fwd (Stable Audio DiT, 47 s, bf16)", "k2_sa_dit_bf16",
             (2, 16, 1012, 64), bf, 0.64),
            ("K2 flash_attention_fwd (ACE-Step DiT, 30 s, bf16)", "k2_ace_dit_bf16",
             (2, 16, 323, 64), bf, 0.64)):
        q, k, v = (sd * rnd(qs, torch.float32) for _ in range(3))
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        fp32 = dt == torch.float32
        rec = check_kernel(
            label, lambda q, k, v: A.flash_attention_fwd(q, k, v),
            lambda q, k, v: A.flash_attention_reference(q, k, v, False, 0.125),
            sdpa(False), (q, k, v), attention_shape(q, k, False),
            *(k2_music_tol if fp32 else k1_tol), attention_work(q, k, False),
            PEAK_FP32 if fp32 else PEAK_BF16, k2_rep, iters=200)
        expect(hopper_launches(lambda: A.flash_attention_fwd(q, k, v),
                               A.flash_attention_fwd) == (0 if fp32 else 1),
               f"{label}: the launch was {'' if fp32 else 'not '}on the Hopper design")
        rec.update(case=key, kernel="K2", on_main_path=False, on_music_path=True,
                   k2_route=A.k2_route(qs[0] * qs[1], qs[2], qs[2], 64, dt, False, True))
        recs.append(rec)
        del q, k, v
    # ACE-Step's clips under about 12 s: every key fits one 128-key block, so
    # the DiT's self-attention takes K1 (the served 10 s request: 108 frames)
    from audiolab_tpu_torch.models.acestep import ACEStepConfig

    t_short = max(1, int(round(MUSIC_SERVED_S * ACEStepConfig().latent_rate)))
    qs = (2, 16, t_short, 64)
    q, k, v = (0.64 * rnd(qs, torch.float32).to(bf) for _ in range(3))
    label = f"K1 attention_nk1 (ACE-Step DiT, {MUSIC_SERVED_S:g} s, bf16)"
    rec = check_kernel(
        label, lambda q, k, v: A.flash_attention(q, k, v),
        lambda q, k, v: A.attention_nk1_reference(q, k, v, 0.125),
        sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
        attention_work(q, k, False), PEAK_BF16, k1_rep, iters=200)
    route = A.k1_route(qs[0] * qs[1], t_short, t_short, 64, bf)
    expect(route == "time", f"{label}: routed to {route}")
    expect(hopper_launches(lambda: A.flash_attention(q, k, v), A.attention_nk1) == 1,
           f"{label}: the launch was not on K1's Hopper design")
    rec.update(case="k1_ace_dit_short", kernel="K1", on_main_path=False, on_music_path=True,
               k1_route=route)
    recs.append(rec)
    del q, k, v
    # the LoRA path at the trainer's shapes (the DiT at ACEStepConfig(),
    # batch 2 x 16 heads, bf16): 32-frame segments take K1, 200 frames the
    # 16-bit K2.  The record is the kernel's forward, held against its plain
    # version and timed and bounded alone.  The gradient through the wrapper
    # (kernels/attention.py::_K1Grad, _K2Grad) is a note beside it: its
    # backward recomputes the plain version from the saved q, k, v, so it
    # equals the plain version's gradient by construction; the note shows
    # that, and times forward + backward beside the plain version's and
    # SDPA's.  The whole-DiT check that the kernel's forward feeds the
    # gradient is phase lora's (b).
    for label, key, kern, t in (("K1 attention_nk1 (LoRA, 32 frames)", "k1_lora", "K1", 32),
                                ("K2 flash_attention_fwd (LoRA, 200 frames)", "k2_lora",
                                 "K2", 200)):
        qs = (2, 16, t, 64)
        q, k, v = (0.64 * rnd(qs, torch.float32).to(bf) for _ in range(3))
        go = rnd(qs, torch.float32).to(bf)
        plain = (A.attention_nk1_reference if kern == "K1"
                 else lambda q, k, v, s: A.flash_attention_reference(q, k, v, False, s))
        rep = k1_rep if kern == "K1" else k2_rep
        rec = check_kernel(
            label, lambda q, k, v: A.flash_attention(q, k, v),
            lambda q, k, v: plain(q, k, v, 0.125), sdpa(False), (q, k, v),
            attention_shape(q, k, False), *k1_tol, attention_work(q, k, False), PEAK_BF16,
            rep, iters=200)
        wrapper = A.attention_nk1 if kern == "K1" else A.flash_attention_fwd
        grad_call = with_grad(lambda q, k, v: A.flash_attention(q, k, v), go)
        plain_grad = with_grad(lambda q, k, v: plain(q, k, v, 0.125), go)
        expect(hopper_launches(lambda: grad_call(q, k, v), wrapper) == 1,
               f"{label}: the forward under autograd was not one launch on the Hopper design")
        got, want = grad_call(q, k, v), plain_grad(q, k, v)
        grad_err = (got.float() - want.float()).abs().max().item()
        expect(bool(torch.isfinite(got).all()) and grad_err == 0.0,
               f"{label}: the gradient through the wrapper is not the plain version's "
               f"(max diff {grad_err:.3e})")
        del got, want
        grad = dict(max_abs_err_vs_plain=grad_err,
                    note="backward = autograd of the plain version at the saved q, k, v "
                         "(no TPU backward kernel): equal to the plain gradient by "
                         "construction, not a check of the kernel",
                    ms=cuda_ms(lambda: grad_call(q, k, v), iters=50, warmup=3),
                    plain_ms=cuda_ms(lambda: plain_grad(q, k, v), iters=10),
                    library_ms=cuda_ms(lambda: with_grad(sdpa(False), go)(q, k, v), iters=50))
        log(f"[kernels] {label} gradient through the wrapper: max diff {grad_err:.3e} from "
            f"the plain version's ({grad['note']}); forward + backward {grad['ms']:.3f} ms, "
            f"plain {grad['plain_ms']:.3f} ms, SDPA {grad['library_ms']:.3f} ms | {card}")
        route = (A.k1_route(32, t, t, 64, bf) if kern == "K1"
                 else A.k2_route(32, t, t, 64, bf, False, True))
        rec.update(case=key, kernel=kern, on_main_path=False, on_lora_path=True,
                   backward="plain PyTorch gradient (no TPU backward kernel)", grad=grad,
                   **({"k1_route": route} if kern == "K1" else {"k2_route": route}))
        recs.append(rec)
        del q, k, v, go
    # the language model's uncached prefill is on the engines path too
    for rec in recs:
        if rec["case"] == "k2_lm_prefill_bf16":
            rec["on_engines_path"] = True

    # long sequences, where every CTA pulls a slice's K and V from L2 again for
    # its 128 query rows: the 16-bit K2 beside SDPA, timed only
    for d in (64, 128):
        q, k, v = (rnd((4, 16, 4096, d), bf) for _ in range(3))
        compare(f"K2 Hopper design vs SDPA, 64 x 4096 x 4096 x {d} bf16, not causal", {
            "K2": lambda: A.flash_attention_fwd(q, k, v),
            "SDPA": lambda: F.scaled_dot_product_attention(q, k, v),
        }, card)
        del q, k, v
        torch.cuda.empty_cache()
    # a decode step (one query row): k2_route keeps it on the Hopper design
    q, k, v = rnd((1, 16, 1, 128), bf), rnd((1, 16, 2048, 128), bf), rnd((1, 16, 2048, 128), bf)
    compare("K2 Hopper design vs row-per-thread-group kernel, decode step 16 x 1/2048 x 128", {
        "hopper": lambda: A.flash_attention_fwd(q, k, v, causal=True),
        "core": lambda: A.flash_attention_fwd_core(q, k, v, causal=True),
    }, card)
    del q, k, v

    # K3: the RoFormer time axis with rope fused (block_k 768 routes it here)
    time_shape = (496, 8, 690, 64)
    q, k, v = rnd(time_shape, bf), rnd(time_shape, bf), rnd(time_shape, bf)
    cos, sin = (t.to(dev) for t in A.rope_tables(690, 64))
    flops, nbytes, exps = attention_work(q, k, False)
    rec = check_kernel(
        "K3 attention_nk1_rope (RoFormer time axis)",
        lambda q, k, v: A.flash_attention(q, k, v, block_k=768, rope_cos=cos, rope_sin=sin),
        lambda q, k, v: A.attention_nk1_rope_reference(q, k, v, cos, sin, scale),
        None, (q, k, v), attention_shape(q, k, False), *k1_tol,
        (flops, nbytes + 2 * cos.numel() * 4, exps), PEAK_BF16,
        "audiolab_tpu/kernels/attention.py:142",
        library_note="no single PyTorch call ropes and attends")
    route = A.k3_route(time_shape[0] * time_shape[1], 690, 690, 64, bf, True)
    expect(route == "time", f"K3: routed to {route}")
    expect(hopper_launches(lambda: A.attention_nk1_rope(q, k, v, cos, sin),
                           A.attention_nk1_rope) == 1,
           "K3: the launch was not on the Hopper design")
    means = compare("K3 Hopper time route vs WMMA core", {
        "hopper": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "core": lambda: A.attention_nk1_rope_core(q, k, v, cos, sin),
    }, card)
    rec.update(case="k3_time", kernel="K3", on_main_path=False, k3_route=route,
               core_ms=means["core"], compare_hopper_ms=means["hopper"])
    recs.append(rec)
    compare("K3 fused rope vs apply_rope_tables + K1 (time axis)", {
        "K3": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "rope+K1": lambda: A.attention_nk1(A.apply_rope_tables(q, cos, sin),
                                           A.apply_rope_tables(k, cos, sin), v),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()
    # a band-shaped call: k3_route sends it to the time design over one chunk
    band_shape = (5520, 8, 62, 64)
    q, k, v = rnd(band_shape, bf), rnd(band_shape, bf), rnd(band_shape, bf)
    compare("K3 Hopper time route (one chunk) vs WMMA core (band axis)", {
        "hopper": lambda: A.attention_nk1_rope(q, k, v, cos, sin),
        "core": lambda: A.attention_nk1_rope_core(q, k, v, cos, sin),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()

    # K7: the time axis in the packed (b, t, h*d) layout, contiguous and read
    # straight from a fused (b, t, 3*h*d) qkv activation
    b, t, h, d = 496, 690, 8, 64
    inner = h * d
    qkv = rnd((b, t, 3 * inner), bf)

    def heads_first(x):
        return x.view(b, t, h, d).transpose(1, 2)

    k7_recs = {}
    for layout in ("packed", "qkv views"):
        q, k, v = qkv.split(inner, dim=-1)
        if layout == "packed":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        route = A.k7_route(b, h, t, d, q.stride(1), bf, True)
        expect(route == "time", f"K7 ({layout}): routed to {route}")
        expect(hopper_launches(lambda: A.packed_attention(q, k, v, h, d),
                               A.packed_attention) == 1,
               f"K7 ({layout}): the launch was not on the Hopper design")
        rec = check_kernel(
            f"K7 packed_attention (RoFormer time axis, {layout})",
            lambda q, k, v: A.packed_attention(q, k, v, h, d),
            lambda q, k, v: A.packed_attention_reference(q, k, v, h, d, scale),
            lambda q, k, v: F.scaled_dot_product_attention(heads_first(q), heads_first(k),
                                                           heads_first(v)),
            (q, k, v), dict(q=list(q.shape), row_stride=q.stride(1), heads=h, dim_head=d,
                            dtype=str(q.dtype)), *k1_tol,
            attention_work(heads_first(q), heads_first(k), False), PEAK_BF16,
            "tools/probe_packed_attn.py:68")
        means = compare(f"K7 Hopper time route vs WMMA core ({layout})", {
            "hopper": lambda: A.packed_attention(q, k, v, h, d),
            "core": lambda: A.packed_attention_core(q, k, v, h, d),
        }, card)
        rec.update(case="k7_time" if layout == "packed" else "k7_time_views", kernel="K7",
                   on_main_path=False, k7_route=route, core_ms=means["core"],
                   compare_hopper_ms=means["hopper"])
        recs.append(rec)
        k7_recs[layout] = (q, k, v)
    qp, kp, vp = k7_recs["packed"]
    qs, ks, vs = k7_recs["qkv views"]
    q1, k1, v1 = (heads_first(x).contiguous() for x in (qp, kp, vp))
    del k7_recs

    def split_transpose_k1():
        o = A.attention_nk1(heads_first(qs).contiguous(), heads_first(ks).contiguous(),
                            heads_first(vs).contiguous())
        return o.transpose(1, 2).reshape(b, t, inner)

    compare("K7 on each layout vs K1's time route on the same slices", {
        "K7 packed": lambda: A.packed_attention(qp, kp, vp, h, d),
        "K7 qkv views": lambda: A.packed_attention(qs, ks, vs, h, d),
        "K1": lambda: A.attention_nk1(q1, k1, v1),
    }, card)
    del q1, k1, v1, qp, kp, vp
    compare("K7 on the fused qkv's views vs split + 3 transposes + K1 + transpose back", {
        "K7": lambda: A.packed_attention(qs, ks, vs, h, d),
        "split+K1": split_transpose_k1,
    }, card)
    del qkv, qs, ks, vs
    torch.cuda.empty_cache()

    # K6: the band axis
    band_shape = (5520, 8, 62, 64)
    q, k, v = rnd(band_shape, bf), rnd(band_shape, bf), rnd(band_shape, bf)
    route = A.k6_route(band_shape[0] * band_shape[1], 62, 62, 64, bf, True)
    expect(route == "band", f"K6: routed to {route}")
    expect(hopper_launches(lambda: A.slim_attention(q, k, v), A.slim_attention) == 1,
           "K6: the launch was not on the Hopper design")
    rec = check_kernel(
        "K6 slim_attention (RoFormer band axis)",
        lambda q, k, v: A.slim_attention(q, k, v),
        lambda q, k, v: A.attention_nk1_reference(q, k, v, scale),
        sdpa(False), (q, k, v), attention_shape(q, k, False), *k1_tol,
        attention_work(q, k, False), PEAK_BF16, "tools/probe_freq_bh128.py:36")
    means = compare("K6 Hopper band route vs WMMA core", {
        "hopper": lambda: A.slim_attention(q, k, v),
        "core": lambda: A.slim_attention_core(q, k, v),
    }, card)
    rec.update(case="k6_band", kernel="K6", on_main_path=False, k6_route=route,
               core_ms=means["core"], compare_hopper_ms=means["hopper"])
    recs.append(rec)
    compare("K6 vs K1 (band axis)", {
        "K6": lambda: A.slim_attention(q, k, v),
        "K1": lambda: A.attention_nk1(q, k, v),
    }, card)
    del q, k, v
    torch.cuda.empty_cache()

    # K4, K5: the RoFormer's time-axis activation, 8 chunks x 62 bands x 690
    # frames at dim 512
    x = rnd((8 * 62 * 690, 512), bf)
    w = 1.0 + 0.1 * rnd((512,), torch.float32)
    bias = 0.1 * rnd((512,), torch.float32)
    w_lib, b_lib = w.to(bf), bias.to(bf)
    norm_shape = dict(x=list(x.shape), dtype=str(x.dtype), params="float32")
    rec = check_kernel(
        "K4 rms_norm (RoFormer time-axis activation)",
        lambda x, w: N.rms_norm(x, w), lambda x, w: N.rms_norm_reference(x, w),
        lambda x, w: F.rms_norm(x, (512,), w_lib, 1e-5), (x, w), norm_shape, *norm_tol,
        norm_work(x, (w,)), PEAK_FP32, "audiolab_tpu/kernels/norms.py:30",
        source="audiolab_tpu_torch/csrc/norms.cu",
        library_note="weight in bf16: F.rms_norm's fused path needs the input's type")
    rec.update(case="k4_time", kernel="K4", on_main_path=False)
    recs.append(rec)
    rec = check_kernel(
        "K5 layer_norm (RoFormer time-axis activation)",
        lambda x, w, bias: N.layer_norm(x, w, bias),
        lambda x, w, bias: N.layer_norm_reference(x, w, bias),
        lambda x, w, bias: F.layer_norm(x, (512,), w_lib, b_lib, 1e-5), (x, w, bias),
        norm_shape, *norm_tol, norm_work(x, (w, bias)), PEAK_FP32,
        "audiolab_tpu/kernels/norms.py:38", source="audiolab_tpu_torch/csrc/norms.cu",
        library_note="weight and bias in bf16: F.layer_norm needs the input's type")
    rec.update(case="k5_time", kernel="K5", on_main_path=False)
    recs.append(rec)
    del x
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------- models

def build_separator(dev, cfg_kw=SEP_CFG, sr=SEP_SR, chunk_s=8.0, overlap_s=0.5):
    """Two BS-RoFormer members with distinct seeded weights, made on ``dev``
    and filled by bench.py's rules (utils/fast_init.py)."""
    import torch

    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
    from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cfg = RoformerConfig(**cfg_kw)
    members = []
    for i, (wv, wi) in enumerate(MEMBER_WEIGHTS):
        with torch.device(dev):
            model = fast_init(BSRoformer(cfg), seed=100 + i)
        members.append(EnsembleMember(f"bs_roformer_{i}", model, wv, wi))
    return StemSeparator(members, sr=sr, chunk_seconds=chunk_s, overlap_seconds=overlap_s,
                         device_batch=8, device=dev)


def build_rvc(dev, synth_kw=None, hubert_kw=None, rmvpe_kw=None, index_rows=4096,
              index_dim=768, rvc_kw=None):
    """v2-48k synthesizer, HuBERT, RMVPE (bf16 U-Net) and a seeded index,
    wrapped twice: under the bf16 matmul policy (the default) and under fp32.
    Weights are filled by bench.py's rules (utils/fast_init.py)."""
    import torch

    from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.rvc.synthesizer import (
        SynthesizerConfig,
        SynthesizerTrn,
        config_for,
    )
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        synth = SynthesizerTrn(SynthesizerConfig(**synth_kw) if synth_kw
                               else config_for(48000, "v2"))
        hubert = HubertFeatureExtractor("v2", HubertConfig(**(hubert_kw or {})))
        rmvpe = RMVPE(**(rmvpe_kw or {}))
    for seed, module in enumerate((synth, hubert, rmvpe)):
        fast_init(module, seed)
    index = np.random.default_rng(0).standard_normal((index_rows, index_dim)).astype(np.float32)
    kw = dict(sr=48000, f0_method="rmvpe", **(rvc_kw or {}))
    return {prec: VoiceConverter(synth, hubert, rmvpe, index_features=index, device=dev,
                                 cfg=RVCPipelineConfig(matmul_precision=prec, **kw))
            for prec in ("bfloat16", "highest")}


def to_rvc_input(vocals):
    """Device mono mix and 44.1 -> 16 kHz polyphase resample."""
    from audiolab_tpu_torch.kernels.resample import resample

    return resample(vocals.mean(dim=0), SEP_SR, RVC_SR)


def mel_l1(a, b, sr: int) -> float:
    """tests/test_fidelity.py's measure: mean |log-mel difference|."""
    from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram

    n = min(a.shape[-1], b.shape[-1])
    ma = log_mel(mel_spectrogram(a[..., :n].float()[None], sr=sr, n_fft=1024, hop=256,
                                 n_mels=80, power=1.0))
    mb = log_mel(mel_spectrogram(b[..., :n].float()[None], sr=sr, n_fft=1024, hop=256,
                                 n_mels=80, power=1.0))
    return float((ma - mb).abs().mean())


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def counts() -> dict[str, int]:
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    return {"K1": A.attention_nk1.launches, "K2": A.flash_attention_fwd.launches,
            "K3": A.attention_nk1_rope.launches, "K4": N.rms_norm.launches,
            "K5": N.layer_norm.launches, "K6": A.slim_attention.launches,
            "K7": A.packed_attention.launches}


def reset_counts() -> None:
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels import norms as N

    A.reset_launch_counts()
    N.reset_launch_counts()


def only(launches: dict, kernel: str, n: int) -> bool:
    """``kernel`` launched n times and every other kernel not at all."""
    return all(launches[k] == (n if k == kernel else 0) for k in KERNELS)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_separator(dev, sep, audio, expect_k1: int | None = 48) -> tuple[dict, dict, float]:
    """Main path, part 1: counts reset just before, read just after."""
    import torch

    from audiolab_tpu_torch.kernels import attention as A

    reset_counts()
    t0 = time.perf_counter()
    stems = sep.separate(audio, as_numpy=False)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = counts()
    k1_hopper = A.attention_nk1.sm90_launches
    n = audio.shape[-1]
    ok_shape = all(tuple(v.shape) == (2, n) for v in stems.values())
    finite = all(bool(torch.isfinite(v).all()) for v in stems.values())
    log(f"[separator] 2 members x {sep.members[0].apply_fn.cfg.depth} axial pairs, "
        f"dim {sep.members[0].apply_fn.cfg.dim}, {n / SEP_SR:.1f} s stereo: "
        f"stems {sorted(stems)} shapes {[tuple(v.shape) for v in stems.values()]} "
        f"finite {finite} launches {launches} (K1 on the Hopper routes: {k1_hopper}) "
        f"{secs:.3f} s")
    expect(ok_shape and finite, "separator: stem shape or finiteness")
    expect(set(stems) == {"vocals", "instrumental"}, "separator: stems")
    if expect_k1 is not None:
        expect(only(launches, "K1", expect_k1),
               f"separator: launches {launches}, expected K1 {expect_k1} and no other")
        expect(k1_hopper == expect_k1,
               f"separator: {k1_hopper} of {launches['K1']} K1 launches on the Hopper routes")
    return stems, launches, secs


def phase_rvc(dev, vc, vocals, expect_k2: int | None = 12) -> tuple[object, object, dict, float]:
    """Main path, part 2: counts reset just before, read just after."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    x16 = to_rvc_input(vocals)
    out = vc.convert(x16, sid=0, seed=0, as_numpy=False)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = counts()
    n_out = int(round(x16.shape[-1] * vc.synth_cfg.sr / RVC_SR))
    finite = bool(torch.isfinite(out).all())
    log(f"[rvc] {x16.shape[-1] / RVC_SR:.1f} s at 16 kHz -> {tuple(out.shape)} at "
        f"{vc.synth_cfg.sr} Hz (expected {n_out}) finite {finite} peak "
        f"{float(out.abs().max()):.4f} launches {launches} {secs:.3f} s")
    expect(tuple(out.shape) == (n_out,) and finite, "rvc: output length or finiteness")
    if expect_k2 is not None:
        expect(only(launches, "K2", expect_k2),
               f"rvc: launches {launches}, expected K2 {expect_k2} and no other")
    return x16, out, launches, secs


def phase_fidelity(dev, vcs, x16, out_bf16) -> float:
    """bf16 matmul policy against fp32 on the same input, RMVPE and noise.
    The gate is held with retrieval off: against a random index every
    query's neighbours are near-ties, so any change to the features (bf16
    rounding, or fp32 sums in another order) swaps some of the 8 neighbours
    and the blended features jump.  The chain's own setting (retrieval at
    0.75) is printed beside it."""
    t0 = time.perf_counter()
    sr = vcs["highest"].synth_cfg.sr
    chain32 = vcs["highest"].convert(x16, sid=0, seed=0, as_numpy=False)
    chain_err = mel_l1(out_bf16, chain32, sr)
    off = {p: vcs[p].convert(x16, sid=0, seed=0, index_rate=0.0, as_numpy=False)
           for p in ("bfloat16", "highest")}
    sync(dev)
    err = mel_l1(off["bfloat16"], off["highest"], sr)
    mx = float((off["bfloat16"] - off["highest"]).abs().max())
    log(f"[fidelity] bf16 policy vs fp32, same input/RMVPE/noise, retrieval off: "
        f"mel-L1 {err:.6f} (gate < {MEL_L1_GATE}) max|diff| {mx:.3e} peak "
        f"{float(off['highest'].abs().max()):.4f}; with the chain's retrieval (0.75, "
        f"random index, not gated): mel-L1 {chain_err:.6f}; "
        f"{time.perf_counter() - t0:.3f} s {'OK' if err < MEL_L1_GATE else 'FAIL'}")
    expect(err < MEL_L1_GATE, f"fidelity: mel-L1 {err} >= {MEL_L1_GATE}")
    phase_fidelity_index(dev, vcs, x16, chain_err)
    phase_conv_policy(dev, vcs, x16, off["highest"], chain32)
    return err


def phase_fidelity_index(dev, vcs, x16, random_err: float, clusters: int = 256) -> float:
    """The bf16 policy against fp32 with retrieval on (0.75) over an index of
    well-separated rows: the k-means centres (``clusters``) of the track's
    own HuBERT layer-12 features (fp32, the high-passed 16 kHz input in 8 s
    chunks) plus noise of 5 % of the features' spread.  Beside it the tie
    measure of each index: the median over the track's feature rows of
    (d9 - d8) / d8, the gap between the 8th and 9th nearest rows that a
    rounding must cross to swap a neighbour of the 8-row blend.  Printed,
    not gated: it tells whether the random index's mel-L1 comes from its
    near-ties or from the policy."""
    import torch

    from audiolab_tpu_torch.core import precision as P
    from audiolab_tpu_torch.pipelines.rvc import _highpass_device
    from audiolab_tpu_torch.retrieval.index import _topk_l2, kmeans

    t0 = time.perf_counter()
    vc32 = vcs["highest"]
    sr = vc32.synth_cfg.sr
    x = _highpass_device(x16)
    n = x.shape[-1] // 128000 * 128000
    with torch.inference_mode(), P.matmul_precision("highest"):
        feats = vc32.hubert(x[:n].reshape(-1, 128000)).float()
    feats = feats.reshape(-1, feats.shape[-1])
    centres = kmeans(feats, n_clusters=clusters, iters=20, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    index = centres + 0.05 * feats.std() * torch.randn(centres.shape, generator=g, device=dev)

    def tie_margin(data) -> float:
        d2, _ = _topk_l2(feats, data, k=9)
        d = torch.sqrt(torch.clamp(d2.float(), min=0.0))
        return float(((d[:, 8] - d[:, 7]) / torch.clamp(d[:, 7], min=1e-12)).median())

    random_margin = tie_margin(vc32.index_features)
    margin = tie_margin(index)
    saved = {p: vcs[p].index_features for p in vcs}
    try:
        for p in vcs:
            vcs[p].index_features = index
        on = {p: vcs[p].convert(x16, sid=0, seed=0, as_numpy=False) for p in vcs}
    finally:
        for p in vcs:
            vcs[p].index_features = saved[p]
    sync(dev)
    err = mel_l1(on["bfloat16"], on["highest"], sr)
    log(f"[fidelity] bf16 policy vs fp32 with retrieval on (0.75): the random "
        f"{tuple(saved['highest'].shape)} index mel-L1 {random_err:.6f} (tie margin "
        f"{random_margin:.2e}); an index of the k-means centres of the track's own "
        f"{feats.shape[0]} HuBERT rows ({clusters} centres + 5 % noise) mel-L1 {err:.6f} "
        f"(tie margin {margin:.2e}); gate < {MEL_L1_GATE}, not held here; "
        f"{time.perf_counter() - t0:.3f} s")
    expect(bool(torch.isfinite(on["bfloat16"]).all()), "fidelity index: output not finite")
    return err


def phase_conv_policy(dev, vcs, x16, ref_off, ref_on) -> None:
    """The policy's convolutions (TF32 cuDNN on bf16-rounded operands)
    against the two other ways to run them: the fp32 call with TF32 off
    (the same function, on the CUDA cores) and the bf16 call, whose result
    is rounded to bf16 (the policy's earlier form).  One convolution at the NSF
    decoder's first shape against fp64 on the rounded operands, then the
    RVC stage's seconds in turns and its mel-L1 against fp32 each way."""
    import torch
    import torch.nn.functional as F

    from audiolab_tpu_torch.core import precision as P

    port = P._conv
    ways = {
        "tf32 on rounded operands (the port's)": port,
        "fp32, TF32 off": lambda fn, x, w, *a: fn(P._round(x), P._round(w), None, *a),
        "bf16 call, result rounded": lambda fn, x, w, *a: fn(
            x.bfloat16(), w.bfloat16(), None, *a).float(),
    }
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 512, 12000, device=dev, generator=g)
    w = 0.05 * torch.randn(256, 512, 7, device=dev, generator=g)
    ref = F.conv1d(P._round(x).double(), P._round(w).double(), padding=3)
    vc = vcs["bfloat16"]
    sr = vc.synth_cfg.sr
    res = {}
    try:
        for name, conv in ways.items():
            P._conv = conv
            with P.matmul_precision("bfloat16"):
                y = P.conv1d(x, w, None, 1, 3)
                rel = float((y.double() - ref).abs().max() / ref.abs().max())
                ms = cuda_ms(lambda: P.conv1d(x, w, None, 1, 3), iters=10, warmup=2)
            off = vc.convert(x16, sid=0, seed=0, index_rate=0.0, as_numpy=False)
            on = vc.convert(x16, sid=0, seed=0, as_numpy=False)
            res[name] = dict(rel=rel, ms=ms, mel_off=mel_l1(off, ref_off, sr),
                             mel_on=mel_l1(on, ref_on, sr), rvc_s=[])
        for rep in range(3):
            for name in (list(ways) if rep % 2 == 0 else list(ways)[::-1]):
                P._conv = ways[name]
                sync(dev)
                t0 = time.perf_counter()
                vc.convert(x16, sid=0, seed=0, as_numpy=False)
                sync(dev)
                res[name]["rvc_s"].append(time.perf_counter() - t0)
    finally:
        P._conv = port
    for name, r in res.items():
        log(f"[fidelity] convolutions as {name}: 8 x 512 x 12000 by 256 x 512 x 7 "
            f"{r['ms']:.3f} ms, max|err| / max|y| against fp64 on the rounded operands "
            f"{r['rel']:.3e}; RVC on the 60 s vocals in turns "
            f"{' / '.join(f'{s:.3f}' for s in r['rvc_s'])} s; mel-L1 against fp32, "
            f"retrieval off {r['mel_off']:.6f}, on {r['mel_on']:.6f}")
    # fp32 sums read about 1e-5 of max|y| here, a bf16 result rounding 3e-3
    expect(res[next(iter(ways))]["rel"] < 1e-4,
           "fidelity: the policy's convolution is not the fp32 sum of rounded operands")


def rvc_plan(vc, n16: int):
    """The chunk plan ``convert`` makes of an ``n16``-sample 16 kHz input."""
    from audiolab_tpu_torch.core.chunking import plan_chunks

    chunk = int(vc.cfg.chunk_seconds * RVC_SR)
    overlap = int(vc.cfg.overlap_seconds * RVC_SR)
    return plan_chunks(n16, chunk - chunk % 320, overlap - overlap % 320)


def rvc_groups(vc, n16: int) -> int:
    """Device groups ``convert`` runs on an ``n16``-sample 16 kHz input."""
    count = rvc_plan(vc, n16).count
    return -(-count // max(1, min(vc.cfg.device_batch, count)))


def phase_f0(dev, vc, vocals) -> dict:
    """The f0 methods beside rmvpe, each a ``convert`` of the separator's
    vocals with counts reset just before and read just after: 12 K2 (HuBERT)
    a group and no other kernel."""
    import torch

    from audiolab_tpu_torch.core.chunking import extract_chunks
    from audiolab_tpu_torch.dsp.f0 import f0_harvest
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter

    x16 = to_rvc_input(vocals)
    groups = rvc_groups(vc, x16.shape[-1])
    secs = {}
    for label, method, rmvpe in (("yin, no RMVPE: fused into the conversion", "yin", None),
                                 ("rmvpe+", "rmvpe+", vc.rmvpe),
                                 ("hybrid harvest + rmvpe+", ["harvest", "rmvpe+"], vc.rmvpe)):
        v = VoiceConverter(vc.synth, vc.hubert, rmvpe, index_features=vc.index_features,
                           cfg=RVCPipelineConfig(sr=vc.cfg.sr, f0_method=method,
                                                 matmul_precision=vc.cfg.matmul_precision),
                           device=dev)
        reset_counts()
        t0 = time.perf_counter()
        out = v.convert(x16, sid=0, seed=0, as_numpy=False)
        sync(dev)
        secs[label] = time.perf_counter() - t0
        launches = counts()
        n_out = int(round(x16.shape[-1] * v.synth_cfg.sr / RVC_SR))
        finite = bool(torch.isfinite(out).all())
        log(f"[f0] {label}: {x16.shape[-1] / RVC_SR:.1f} s -> {tuple(out.shape)} finite "
            f"{finite} peak {float(out.abs().max()):.4f} launches {launches} "
            f"{secs[label]:.3f} s")
        expect(tuple(out.shape) == (n_out,) and finite, f"f0 {label}: length or finiteness")
        # CPU tensors take the plain versions and count nothing
        expect(dev.type != "cuda" or only(launches, "K2", HUBERT_LAYERS * groups),
               f"f0 {label}: launches {launches}, expected K2 {HUBERT_LAYERS * groups}")
    plan = rvc_plan(vc, x16.shape[-1])
    rows = extract_chunks(x16, plan).float().cpu().numpy()
    t0 = time.perf_counter()
    for row in rows:
        f0_harvest(row, sr=RVC_SR, hop=160, fmin=vc.cfg.f0_min, fmax=vc.cfg.f0_max)
    secs["harvest on the host alone"] = time.perf_counter() - t0
    log(f"[f0] harvest alone on the host, {len(rows)} chunks of "
        f"{plan.chunk / RVC_SR:.1f} s: {secs['harvest on the host alone']:.3f} s")
    return secs


VR_CASES = (("cascaded_asppnet", "4band_v3"), ("cascaded_net", "1band_sr44100_hl512"))


def phase_vr(dev, vocals, widths: dict | None = None, window: int = 512) -> dict:
    """The VR karaoke split on the stereo vocals stem, one net of each
    generation at VRConfig's default widths (``widths`` overrides them for a
    rehearsal on the CPU), weights by bench.py's rules; counts reset before
    each split and read after (the VR path launches no hand-written
    kernel)."""
    import copy

    import torch

    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.models.separation.vr_bands import (
        BAND_PARAMS,
        combined_spec_to_wave,
        wave_to_combined_spec,
    )
    from audiolab_tpu_torch.pipelines.separate import KARAOKE, vr_split
    from audiolab_tpu_torch.utils.fast_init import fast_init

    secs = {}
    for arch, band in VR_CASES:
        mp = BAND_PARAMS[band]
        cfg = VRConfig(arch=arch, n_fft=2 * mp["bins"], **(widths or {}).get(arch, {}))
        with torch.device(dev):
            net = fast_init(make_vr_net(cfg), seed=200)
        split = vr_split(net, band, KARAOKE, window_size=window, device=dev)
        runs = []
        for _ in range(2):      # the first pass meets these shapes for the first time
            reset_counts()
            t0 = time.perf_counter()
            out = split(vocals, as_numpy=False)
            sync(dev)
            runs.append(time.perf_counter() - t0)
        launches = counts()
        secs[f"{arch} {band}"] = runs
        n = vocals.shape[-1]
        with torch.inference_mode():
            whole = combined_spec_to_wave(wave_to_combined_spec(vocals, mp), mp)
            m = min(n, whole.shape[-1])
            total = out[KARAOKE[0]] + out[KARAOKE[1]]
            err = float((total[:, :m] - whole[:, :m]).abs().max())
            tol = 1e-4 * float(whole.abs().max()) + 1e-6
            win = wave_to_combined_spec(vocals[:, : 128 * mp["band"][len(mp["band"])]["hl"]], mp)
            win = (win.abs() / win.abs().max())[None, :, : cfg.max_bin, :128]
            got = net(win).cpu()
            ref = copy.deepcopy(net).cpu()(win.cpu())
        ferr = float((got - ref).abs().max())
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        log(f"[vr] {arch} on {band} (n_fft {cfg.n_fft}, window {window}), KARAOKE split of "
            f"{n / SEP_SR:.1f} s stereo vocals: {runs[0]:.3f} s, then {runs[1]:.3f} s; "
            f"stems {[tuple(v.shape) for v in out.values()]} finite {finite} launches "
            f"{launches}; primary + complement vs the band round trip max|diff| {err:.3e} "
            f"(tol {tol:.3e}); one forward {tuple(win.shape)}, card vs CPU fp32 max|diff| "
            f"{ferr:.3e} (tol 1e-4)")
        expect(finite and all(tuple(v.shape) == (2, n) for v in out.values()),
               f"vr {arch}: stem shape or finiteness")
        expect(all(v == 0 for v in launches.values()), f"vr {arch}: launches {launches}")
        expect(err <= tol, f"vr {arch}: stems do not sum to the band round trip")
        expect(ferr <= 1e-4, f"vr {arch}: card vs CPU {ferr}")
        del net, split, out, whole, total
        torch.cuda.empty_cache()
    return secs


def phase_long(dev, sep, vc, card: str, seconds: float = LONG_S) -> dict:
    """bench.py's 4-minute track (seed 0, 0.1 * N(0, 1) stereo) through
    separate -> mono -> 44.1 -> 16 kHz -> convert, once after a pass that
    warms these shapes; counts reset just before the measured pass and read
    just after."""
    import torch

    from audiolab_tpu_torch.core.chunking import plan_chunks
    from audiolab_tpu_torch.kernels import attention as A

    audio = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (2, int(seconds * SEP_SR))) * 0.1).astype(np.float32)).to(dev)
    count = plan_chunks(audio.shape[-1], int(sep.chunk_seconds * SEP_SR),
                        int(sep.overlap_seconds * SEP_SR)).count
    sep_groups = -(-count // min(sep.device_batch, count))
    expect_k1 = len(sep.members) * sep_groups * 2 * sep.members[0].apply_fn.cfg.depth

    def chain():
        t0 = time.perf_counter()
        stems = sep.separate(audio, as_numpy=False)
        sync(dev)
        t1 = time.perf_counter()
        x16 = to_rvc_input(stems["vocals"])
        out = vc.convert(x16, sid=0, seed=0, as_numpy=False)
        sync(dev)
        return stems, x16, out, t1 - t0, time.perf_counter() - t1

    *_, w_sep, w_rvc = chain()
    reset_counts()
    stems, x16, out, t_sep, t_rvc = chain()
    launches = counts()
    k1_hopper = A.attention_nk1.sm90_launches
    expect_k2 = HUBERT_LAYERS * rvc_groups(vc, x16.shape[-1])
    finite = (all(bool(torch.isfinite(v).all()) for v in stems.values())
              and bool(torch.isfinite(out).all()))
    total = t_sep + t_rvc
    log(f"[long] {seconds:.0f} s stereo: {count} chunks in {sep_groups} groups a member; "
        f"first pass at these shapes separate {w_sep:.3f} s rvc {w_rvc:.3f} s; measured pass "
        f"separate {t_sep:.3f} s, rvc {t_rvc:.3f} s, chain {total:.3f} s = "
        f"{seconds / total:.3f} audio-s/s; launches {launches} (K1 on the Hopper routes: "
        f"{k1_hopper}); stems and output finite {finite} | {card}")
    n_out = int(round(x16.shape[-1] * vc.synth_cfg.sr / RVC_SR))
    expect(finite and tuple(out.shape) == (n_out,),
           "long: finiteness or output length")
    expect(dev.type != "cuda" or (
        launches["K1"] == expect_k1 == k1_hopper and launches["K2"] == expect_k2
        and all(launches[k] == 0 for k in KERNELS if k not in ("K1", "K2"))),
           f"long: launches {launches}, expected K1 {expect_k1} (all Hopper), K2 {expect_k2}")
    return dict(sep_s=t_sep, rvc_s=t_rvc, chain_s=total, first_sep_s=w_sep, first_rvc_s=w_rvc)


def phase_reference(dev, sep, vcs) -> None:
    """Full-width modules on short inputs, the card against the CPU's plain
    path, fp32 (attention then runs K2 on the card; K1's numerics are held
    against its plain version in the kernels phase)."""
    import copy

    import torch

    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig

    cpu = torch.device("cpu")
    member = sep.members[0].apply_fn
    cfg32 = RoformerConfig(**{**member.cfg.__dict__, "dtype": "float32"})
    sd = {k: v.detach().cpu() for k, v in member.state_dict().items()}
    models = {}
    for d in (dev, cpu):
        with torch.device(d):
            m = BSRoformer(cfg32)
        m.load_state_dict(sd)
        models[d.type] = m.eval()
    x = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal(
        (1, 2, SEP_SR))).astype(np.float32))
    with torch.inference_mode():
        got = models[dev.type](x.to(dev))["vocals"].cpu()
        ref = models["cpu"](x)["vocals"]
    err = float((got - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    log(f"[reference] BS-RoFormer member fp32, 1 s stereo, card vs CPU: max|diff| "
        f"{err:.3e} (tol {tol:.3e}: 1e-3 of max|vocals|, fp32 sums in another order "
        f"through 24 transformer blocks) {'OK' if err <= tol else 'FAIL'}")
    expect(err <= tol, "reference: separator member card vs CPU")
    del models

    hub = vcs["highest"].hubert
    hub_cpu = copy.deepcopy(hub).to(cpu)
    wav = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal(
        (2, RVC_SR * 2))).astype(np.float32))
    with torch.inference_mode():
        got = hub(wav.to(dev)).cpu()
        ref = hub_cpu(wav)
    err = float((got - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    log(f"[reference] HuBERT fp32 (K2 attention), 2 x 2 s, card vs CPU: max|diff| "
        f"{err:.3e} (tol {tol:.3e}: 1e-3 of max|features|, fp32 sums in another order "
        f"through 12 post-LN layers) {'OK' if err <= tol else 'FAIL'}")
    expect(err <= tol, "reference: HuBERT card vs CPU")


def phase_timing(dev, sep, vc, audio, card: str, profile_dir: str | None) -> dict:
    import torch

    def chain():
        t0 = time.perf_counter()
        stems = sep.separate(audio, as_numpy=False)
        sync(dev)
        t1 = time.perf_counter()
        out = vc.convert(to_rvc_input(stems["vocals"]), sid=0, seed=0, as_numpy=False)
        sync(dev)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, out

    torch.cuda.reset_peak_memory_stats()
    t_sep, t_rvc, _ = chain()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total = t_sep + t_rvc
    dur = audio.shape[-1] / SEP_SR
    # the stages are timed on the host's clock, which a shared host moves by
    # several percent from pass to pass: two more passes show the spread
    again = [sum(chain()[:2]) for _ in range(2)]
    rec = dict(sep_s=t_sep, rvc_s=t_rvc, chain_s=total, audio_s_per_s=dur / total,
               chain_again_s=again, peak_mem_gb=peak_gb, card=card)
    log(f"[timing] warm chain on {dur:.1f} s: separate {t_sep:.3f} s, rvc {t_rvc:.3f} s, "
        f"chain {total:.3f} s = {dur / total:.3f} audio-s/s (two more passes: "
        f"{' / '.join(f'{x:.3f}' for x in again)} s), peak memory "
        f"{peak_gb:.2f} GB | {card}")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chain()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        path = Path(profile_dir) / "chip_smoke_profile.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"{card}\n{table}\n")
        log(f"[timing] profiler table of one chain pass -> {path}")
    return rec


SERVE_TITLES = ["Separate", "Clone", "Export", "Merge"]


def http(method: str, url: str, payload: dict | None = None, timeout: float = 900.0):
    """(status, parsed JSON body) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def check_merged(files: list[dict], work: Path, n: int, label: str) -> float:
    """Exactly one ``*_merged.wav``, finite, non-silent, at the input's rate
    and length; returns its peak."""
    import base64

    from audiolab_tpu_torch.core.audio_io import read_wav

    names = [f["filename"] for f in files]
    expect(len(files) == 1 and names[0].endswith("_merged.wav"),
           f"{label}: returned {names}, expected one *_merged.wav")
    path = work / names[0]
    path.write_bytes(base64.b64decode(files[0]["content"]))
    a = read_wav(path)
    peak = float(np.abs(a.samples).max())
    expect(a.sample_rate == SEP_SR and a.samples.shape == (2, n),
           f"{label}: merged {a.samples.shape} at {a.sample_rate} Hz, expected (2, {n}) at "
           f"{SEP_SR}")
    expect(bool(np.isfinite(a.samples).all()) and peak > 1e-3,
           f"{label}: merged output not finite or silent (peak {peak})")
    return peak


def check_project(project_dir: Path, label: str) -> None:
    """Every stage's files: the stems, the cloned vocals, the DAW project and
    its bundle, the merged track."""
    want = ["stems/track (Vocals).wav", "stems/track (Instrumental).wav",
            "cloned/track (Vocals) (Cloned).wav", "export/track.als",
            "export/track_project.zip", "merged/track_merged.wav"]
    missing = [w for w in want if not (project_dir / w).is_file()]
    expect(not missing, f"{label}: {project_dir} lacks {missing}")


def check_launches(dev, launches: dict, k1_hopper: int, k1: int, k2: int, label: str) -> None:
    """K1 ``k1`` times, all on the Hopper routes, K2 ``k2`` times and no other
    kernel (on the card: CPU tensors take the plain versions and count
    nothing)."""
    if dev.type != "cuda":
        return
    expect(launches["K1"] == k1 == k1_hopper and launches["K2"] == k2
           and all(launches[k] == 0 for k in KERNELS if k not in ("K1", "K2")),
           f"{label}: launches {launches} (K1 on the Hopper routes {k1_hopper}), expected "
           f"K1 {k1} all Hopper, K2 {k2} and no other")


def phase_serve(dev, sep, vc, audio, card: str) -> dict:
    """The product's entry point on the card: the chain's models injected
    through the processors' ``configure``, the track as a WAV, counts reset
    just before each pass and read just after.  Prints the library chain
    (device tensors), ``run_chain`` in the process (WAV files, host
    resample, restore_silence, Export, Merge) and the served requests (HTTP,
    base64 JSON) side by side."""
    import base64
    import dataclasses
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.core.chunking import plan_chunks
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.pipelines.chain import run_chain
    from audiolab_tpu_torch.pipelines.processors.clone import Clone
    from audiolab_tpu_torch.pipelines.processors.separate import Separate
    from audiolab_tpu_torch.pipelines.rvc import VoiceConverter
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    # Clone rewrites its converter's config (rmvpe+ by default): a converter
    # of its own over the same modules leaves the other phases' alone
    vc = VoiceConverter(vc.synth, vc.hubert, vc.rmvpe, index_features=vc.index_features,
                        cfg=dataclasses.replace(vc.cfg, f0_method="rmvpe+"), device=dev)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    n = audio.shape[-1]
    count = plan_chunks(n, int(sep.chunk_seconds * SEP_SR), int(sep.overlap_seconds * SEP_SR)).count
    k1 = len(sep.members) * -(-count // min(sep.device_batch, count)) * 2 * (
        sep.members[0].apply_fn.cfg.depth)
    k2 = HUBERT_LAYERS * rvc_groups(vc, -(-n * RVC_SR // SEP_SR))
    rec: dict = {}
    Separate.configure(sep)
    Clone.configure(vc)
    try:
        wav = work / "track.wav"
        write_wav(wav, audio.float().cpu().numpy(), SEP_SR)
        reset_counts()
        t0 = time.perf_counter()
        stems = sep.separate(audio, as_numpy=False)
        vc.convert(to_rvc_input(stems["vocals"]), sid=0, seed=0, as_numpy=False)
        sync(dev)
        rec["library_chain_s"] = time.perf_counter() - t0
        del stems

        # run_chain in the process, twice: the first pass meets the
        # processors' shapes (rmvpe+, restore_silence, Merge) for the first time
        rec["inproc_s"], rec["inproc_stages_s"] = [], []
        for rep in range(2):
            marks = []

            def mark(_i, msg, _n):
                if msg.startswith("Running "):
                    marks.append((msg[len("Running "):], time.perf_counter()))

            reset_counts()
            t0 = time.perf_counter()
            projs = run_chain(SERVE_TITLES, [str(wav)], {}, output_root=str(work / f"inproc{rep}"),
                              device=dev, callback=mark)
            sync(dev)
            end = time.perf_counter()
            launches = counts()
            stages = {name: (marks[i + 1][1] if i + 1 < len(marks) else end) - t
                      for i, (name, t) in enumerate(marks)}
            rec["inproc_s"].append(end - t0)
            rec["inproc_stages_s"].append(stages)
            check_launches(dev, launches, A.attention_nk1.sm90_launches, k1, k2,
                           f"serve: run_chain pass {rep + 1}")
            check_project(Path(projs[0].project_dir), f"serve: run_chain pass {rep + 1}")
            expect([Path(p).name for p in projs[0].last_outputs] == ["track_merged.wav"],
                   f"serve: run_chain returned {projs[0].last_outputs}")
            log(f"[serve] run_chain in the process, pass {rep + 1}: {end - t0:.3f} s ("
                + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                + f") launches {launches}")

        rec["host_s"] = phase_host_work(dev, wav, Path(projs[0].project_dir))

        served = work / "served" / "process"
        server, port = serve_background(create_app(str(served), device=dev))
        try:
            body = {"files": [{"filename": "track.wav",
                               "content": base64.b64encode(wav.read_bytes()).decode()}],
                    "processors": SERVE_TITLES}
            rec["request_s"], rec["served_launches"] = [], []
            for req, want_k1 in ((1, k1), (2, 0)):
                label = f"serve: request {req}"
                reset_counts()
                t0 = time.perf_counter()
                status, resp = http("POST", f"http://127.0.0.1:{port}/api/v1/process/chain", body)
                sync(dev)
                secs = time.perf_counter() - t0
                launches = counts()
                expect(status == 200, f"{label}: HTTP {status} {resp.get('error')}")
                peak = check_merged(resp["files"], work, n, label)
                projects = sorted(served.iterdir())
                expect(len(projects) == 1, f"{label}: projects {projects}")
                check_project(projects[0], label)
                check_launches(dev, launches, A.attention_nk1.sm90_launches, want_k1, k2, label)
                rec["request_s"].append(secs)
                rec["served_launches"].append(launches)
                log(f"[serve] request {req} POST /api/v1/process/chain {SERVE_TITLES} on "
                    f"{n / SEP_SR:.1f} s ({wav.stat().st_size / 1e6:.1f} MB WAV): HTTP {status} "
                    f"{secs:.3f} s; merged peak {peak:.4f}; launches {launches}"
                    f"{' (Separate from its cache)' if req == 2 else ''} | in the same run: "
                    f"run_chain in the process {rec['inproc_s'][-1]:.3f} s, library chain "
                    f"(separate + convert on device tensors) {rec['library_chain_s']:.3f} s | "
                    f"{card}")
        finally:
            server.shutdown()
            server.server_close()
        rec.update(phase_main(dev, work, wav, n))
    finally:
        Separate.configure(None)
        Clone.configure(None)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return rec


def phase_host_work(dev, wav: Path, project_dir: Path) -> dict:
    """Seconds of the host work a served request adds to the library chain,
    each step once, on this run's files: the WAV codec, the polyphase
    resample and high-pass Clone runs before convert, restore_silence after
    it, Export's zip, and the request's base64 JSON both ways."""
    import base64

    from scipy import signal as sps

    from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
    from audiolab_tpu_torch.dsp.silence import restore_silence
    from audiolab_tpu_torch.kernels.resample import resample_poly_np
    from audiolab_tpu_torch.utils.daw import zip_project

    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        secs[name] = time.perf_counter() - t0
        return out

    a = timed("read_wav", lambda: read_wav(wav))
    timed("write_wav", lambda: write_wav(project_dir / "host_probe.wav", a.samples, SEP_SR))
    mono = 0.5 * (a.samples[0] + a.samples[1])
    x16 = timed("resample_poly_np 44.1 -> 16 kHz", lambda: resample_poly_np(mono, SEP_SR, RVC_SR))
    b, c = sps.butter(5, 48, btype="high", fs=RVC_SR)
    timed("filtfilt 48 Hz", lambda: sps.filtfilt(b, c, x16))
    out48 = np.resize(x16, int(round(len(x16) * 3)))
    timed("restore_silence", lambda: restore_silence(mono, out48, SEP_SR, 48000, device=dev))
    stems = sorted(str(p) for p in project_dir.glob("*/*.wav"))
    timed(f"zip_project of {len(stems)} WAVs",
          lambda: zip_project(str(project_dir / "host_probe.zip"), stems))
    raw = wav.read_bytes()
    body = timed("base64 + JSON encode", lambda: json.dumps(
        {"files": [{"filename": "track.wav", "content": base64.b64encode(raw).decode()}]}))
    timed("JSON + base64 decode", lambda: base64.b64decode(json.loads(body)["files"][0]["content"]))
    log(f"[serve] host work beside the chain, {len(mono) / SEP_SR:.1f} s track: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    return secs


def phase_main(dev, work: Path, wav: Path, n: int) -> dict:
    """``python -m audiolab_tpu_torch.main`` as a user starts it (the card,
    no models injected): the OpenAPI document, the DSP split of the track
    through POST /api/v1/process/separate, then SIGTERM and exit 0."""
    import base64
    import signal
    import socket
    import urllib.error

    from audiolab_tpu_torch.core.audio_io import read_wav

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = open(work / "main.log", "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiolab_tpu_torch.main", "--port", str(port),
         "--output-root", str(work / "main" / "process"), "--device", dev.type],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        while True:
            try:
                status, doc = http("GET", f"{url}/openapi.json", timeout=30)
                break
            except (urllib.error.URLError, ConnectionError):
                expect(proc.poll() is None and time.perf_counter() - t0 < 180,
                       f"main: not serving (exit {proc.poll()}): "
                       f"{(work / 'main.log').read_text()[-2000:]}")
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        expect(status == 200 and "/api/v1/process/chain" in doc["paths"],
               f"main: /openapi.json HTTP {status}")
        t1 = time.perf_counter()
        status, resp = http("POST", f"{url}/api/v1/process/separate", {
            "files": [{"filename": "track.wav",
                       "content": base64.b64encode(wav.read_bytes()).decode()}]})
        sep_s = time.perf_counter() - t1
        expect(status == 200, f"main: separate HTTP {status} {resp.get('error')}")
        names = sorted(f["filename"] for f in resp["files"])
        expect(names == ["track (Instrumental).wav", "track (Vocals).wav"],
               f"main: separate returned {names}")
        for f in resp["files"]:
            p = work / f"main_{f['filename']}"
            p.write_bytes(base64.b64decode(f["content"]))
            a = read_wav(p)
            expect(a.samples.shape == (2, n) and bool(np.isfinite(a.samples).all()),
                   f"main: {f['filename']} {a.samples.shape}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log(f"[serve] python -m audiolab_tpu_torch.main: serving after {up_s:.3f} s, "
            f"{len(doc['paths'])} paths in /openapi.json; POST /api/v1/process/separate (the "
            f"DSP split on {dev.type}, no separator injected) {sep_s:.3f} s; SIGTERM -> exit {rc}")
        expect(rc == 0, f"main: exit {rc} after SIGTERM: "
                        f"{(work / 'main.log').read_text()[-2000:]}")
        return dict(main_up_s=up_s, main_separate_s=sep_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


# ---------------------------------------------------------------- separators

# the reference's blend weights of its MDX23C and first MDX-NET ONNX members
MDX23C_WEIGHTS, ONNX_WEIGHTS = (7.2, 14.9), (6.9, 14.9)
# MDXOnnxSeparator's defaults (UVR MDX-NET: dim_f 3072, dim_t 256, n_fft 7680)
ONNX_IO = dict(dim_f=3072, dim_t=256, n_fft=7680, hop=1024)
# the ONNX member's graph (a U-Net written here, not a published net's):
# channel widths per scale and the TDF's bottleneck factor
ONNX_WIDTHS, ONNX_BN = (32, 64, 128), 8


def mdx_onnx_graph(seed: int, dim_f: int, widths=ONNX_WIDTHS, bn: int = ONNX_BN):
    """An ONNX graph ``input`` (b, 4, dim_f, dim_t) -> ``output`` of the same
    shape, written with the port's ``build_model`` and read back with
    ``parse_model``: a transpose to (b, c, t, f), a 1x1 stem, per scale a 3x3
    conv and a TDF bottleneck (two MatMuls over frequency and a residual
    Add), 2x2 stride-2 downscales, transposed-conv upscales concatenated with
    their skips, a 1x1 head and the transpose back.  Weights N(0, 2 / fan_in),
    biases N(0, 0.01), from ``seed``."""
    from audiolab_tpu_torch.utils.onnx import OnnxNode, build_model, parse_model

    rng = np.random.default_rng(seed)
    nodes, inits = [], {}

    def tensor(shape, std):
        name = f"w{len(inits)}"
        inits[name] = (std * rng.standard_normal(shape)).astype(np.float32)
        return name

    def node(op, ins, **attrs):
        out = f"t{len(nodes)}"
        nodes.append(OnnxNode(op, ins, [out], attrs))
        return out

    def conv(x, cin, cout, k, **attrs):
        w = tensor((cout, cin, k, k), np.sqrt(2.0 / (cin * k * k)))
        return node("Relu", [node("Conv", [x, w, tensor((cout,), 0.01)], **attrs)])

    def tdf(x, f):
        h = node("Add", [node("MatMul", [x, tensor((f, f // bn), np.sqrt(2.0 / f))]),
                         tensor((f // bn,), 0.01)])
        h = node("MatMul", [node("Relu", [h]), tensor((f // bn, f), np.sqrt(1.0 / f))])
        return node("Add", [x, node("Add", [h, tensor((f,), 0.01)])])

    x = node("Transpose", ["input"], perm=[0, 1, 3, 2])
    x = conv(x, 4, widths[0], 1)
    skips, f = [], dim_f
    for i, c in enumerate(widths):
        x = tdf(conv(x, c, c, 3, pads=[1, 1, 1, 1]), f)
        if i + 1 < len(widths):
            skips.append((x, c, f))
            x = conv(x, c, widths[i + 1], 2, strides=[2, 2])
            f //= 2
    c_in = widths[-1]
    for skip, c, f in reversed(skips):
        w = tensor((c_in, c, 2, 2), np.sqrt(1.0 / c_in))
        up = node("ConvTranspose", [x, w, tensor((c,), 0.01)], strides=[2, 2])
        x = tdf(conv(node("Concat", [up, skip], axis=1), 2 * c, c, 3, pads=[1, 1, 1, 1]), f)
        c_in = c
    w = tensor((4, widths[0], 1, 1), np.sqrt(1.0 / widths[0]))
    x = node("Conv", [x, w, tensor((4,), 0.01)])
    nodes.append(OnnxNode("Transpose", [x], ["output"], {"perm": [0, 1, 3, 2]}))
    return parse_model(build_model(nodes, inits, ["input"], ["output"]))


def build_family(dev, sep, cfgs: dict | None = None, onnx_io: dict = ONNX_IO,
                 onnx_widths=ONNX_WIDTHS):
    """The rest of the separator family on ``dev``, weights by bench.py's
    rules (utils/fast_init.py): the ensemble (the separator phase's two
    BS-RoFormer members, MDX23C at MDX23CConfig() = InstVoc_HQ and an MDX-NET
    ONNX member at MDXOnnxSeparator's defaults), HTDemucs at HTDemucsConfig()
    = htdemucs_6s for the 6-stem split, an MDX23C over DRUM_KIT (InstVoc_HQ's
    other widths) for the drum split.  ``cfgs`` overrides the configs by
    "mdx23c" / "htdemucs" (CPU rehearsals)."""
    import torch

    from audiolab_tpu_torch.models.separation.htdemucs import HTDemucs, HTDemucsConfig
    from audiolab_tpu_torch.models.separation.mdx import MDXOnnxSeparator
    from audiolab_tpu_torch.models.separation.mdx23c import MDX23CConfig, TFCTDFNetV3
    from audiolab_tpu_torch.pipelines.separate import (
        DRUM_KIT,
        EnsembleMember,
        StemSeparator,
        htdemucs_member,
        mdx23c_member,
    )
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cfgs = cfgs or {}
    mkw = cfgs.get("mdx23c", {})
    with torch.device(dev):
        mdx = fast_init(TFCTDFNetV3(MDX23CConfig(**mkw)), seed=200)
        htd = fast_init(HTDemucs(HTDemucsConfig(**cfgs.get("htdemucs", {}))), seed=201)
        drum = fast_init(TFCTDFNetV3(MDX23CConfig(**dict(mkw, instruments=DRUM_KIT))), seed=202)
    onnx = MDXOnnxSeparator(mdx_onnx_graph(203, onnx_io["dim_f"], onnx_widths), **onnx_io)
    kw = dict(sr=sep.sr, chunk_seconds=sep.chunk_seconds, overlap_seconds=sep.overlap_seconds,
              device_batch=sep.device_batch, device=dev)
    members = [*sep.members, mdx23c_member(mdx, "mdx23c_instvoc_hq", *MDX23C_WEIGHTS),
               EnsembleMember("mdx_net_onnx", onnx, *ONNX_WEIGHTS)]
    htd_m, drum_m = htdemucs_member(htd), mdx23c_member(drum, "mdx23c_drumsep")
    return dict(ensemble=StemSeparator(members, **kw), multistem=StemSeparator([htd_m], **kw),
                htdemucs=htd_m, drumsep=StemSeparator([drum_m], **kw), drum_kit=drum_m,
                models=dict(htdemucs=htd, mdx23c=mdx, onnx=onnx))


def check_stems(stems: dict, names, n: int, label: str, total=None, tol=None) -> None:
    """``names`` exactly, each (2, n) and finite; with ``total``, the stems
    sum to it within ``tol`` of its peak."""
    import torch

    expect(set(stems) == set(names), f"{label}: stems {sorted(stems)}, expected {sorted(names)}")
    for k, v in stems.items():
        v = torch.as_tensor(v)
        expect(tuple(v.shape) == (2, n) and bool(torch.isfinite(v).all()),
               f"{label}: {k} {tuple(v.shape)} or not finite")
    if total is not None:
        err = float(np.abs(sum(np.asarray(v) for v in stems.values()) - total).max())
        expect(err <= tol * float(np.abs(total).max()),
               f"{label}: the stems miss their input by {err}")


def phase_separators(dev, sep, audio, card: str, cfgs: dict | None = None,
                     onnx_io: dict = ONNX_IO, onnx_widths=ONNX_WIDTHS,
                     expect_k1: int | None = 48, profile_dir: str | None = None) -> dict:
    """The separator family at published widths on the 60 s track, each step
    cold then warm, counts reset just before each pass and read just after:
    (a) the 4-member ensemble (48 K1, all on the Hopper routes, nothing else),
    (b) the 6-stem HTDemucs split (stems sum to the input), (c) the drum split
    of (b)'s drums, (d) POST /api/v1/process/separate with vocals_only off and
    the drum split on (the JAX processor's files), (e) one 8 s chunk through
    HTDemucs, MDX23C and the ONNX runner on the card against the CPU in fp32
    (1e-4 of max|y|), (f) seconds and peak memory, and each ensemble member
    alone, warm; with ``profile_dir`` a profiler table of (a)-(c), warm."""
    import base64
    import copy
    import shutil
    import tempfile
    from functools import partial

    import torch

    from audiolab_tpu_torch.core import precision
    from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.pipelines.processors.separate import Separate
    from audiolab_tpu_torch.pipelines.separate import DRUM_KIT, MULTISTEM_6
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    t0 = time.perf_counter()
    fam = build_family(dev, sep, cfgs, onnx_io, onnx_widths)
    sync(dev)
    log(f"[separators] models built on {dev.type} in {time.perf_counter() - t0:.1f} s")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    n = audio.shape[-1]
    x = audio.float().cpu().numpy()
    rec: dict = {"card": card}

    def timed(label, fn):
        """fn() twice (cold, warm): counts reset before each pass and read
        after; returns the warm result and the first pass's counts."""
        out, first = None, None
        for rep in ("cold", "warm"):
            reset_counts()
            t1 = time.perf_counter()
            out = fn()
            sync(dev)
            rec.setdefault(f"{label}_s", []).append(time.perf_counter() - t1)
            launches = counts() | {"K1_sm90": A.attention_nk1.sm90_launches}
            first = first or launches
            expect(launches == first, f"{label}: launches {launches} warm, {first} cold")
        return out, first

    ens = fam["ensemble"]
    stems, launches = timed("ensemble", lambda: ens.separate(audio, as_numpy=False))
    check_stems(stems, ("vocals", "instrumental"), n, "separators: ensemble")
    if expect_k1 is not None:
        expect(only(launches, "K1", expect_k1) and launches["K1_sm90"] == expect_k1,
               f"separators: ensemble launches {launches}, expected K1 {expect_k1} all Hopper")
    rec["ensemble_launches"] = launches
    del stems

    # each member alone, warm, as separate() runs it
    rec["member_s"] = {}
    with torch.inference_mode(), precision.matmul_precision(ens.matmul_precision):
        for m in ens.members:
            t1 = time.perf_counter()
            ens._run_member(m, audio)
            sync(dev)
            rec["member_s"][m.name] = time.perf_counter() - t1

    six, launches = timed("multistem", lambda: fam["multistem"].separate_multistem(
        x, fam["htdemucs"]))
    check_stems(six, MULTISTEM_6, n, "separators: 6-stem split", total=x, tol=1e-4)
    expect(all(v == 0 for v in launches.values()), f"separators: 6-stem launches {launches}")
    kit, launches = timed("drums", lambda: fam["drumsep"].separate_multistem(
        six["drums"], fam["drum_kit"]))
    check_stems(kit, DRUM_KIT, n, "separators: drum split", total=six["drums"], tol=1e-4)
    expect(all(v == 0 for v in launches.values()), f"separators: drum launches {launches}")

    if profile_dir and cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ens.separate(audio, as_numpy=False)
            fam["multistem"].separate_multistem(x, fam["htdemucs"])
            fam["drumsep"].separate_multistem(six["drums"], fam["drum_kit"])
            sync(dev)
        wall = time.perf_counter() - t1
        events = prof.key_averages()
        # the kernels and copies themselves (an operator's row repeats its kernels' time)
        device_s = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA) / 1e6
        path = Path(profile_dir) / "chip_smoke_separators_profile.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"{card}\n(a)-(c) warm: {wall:.3f} s on the host clock, {device_s:.3f} s "
                        f"of device time\n"
                        + events.table(sort_by="self_cuda_time_total", row_limit=40) + "\n")
        rec["profile"] = dict(wall_s=wall, device_s=device_s)
        log(f"[separators] profiler: (a)-(c) warm {wall:.3f} s on the host clock, "
            f"{device_s:.3f} s of device time -> {path}")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_separators_"))
    Separate.configure(ens, multistem=partial(fam["multistem"].separate_multistem,
                                              member=fam["htdemucs"]),
                       drum_splitter=partial(fam["drumsep"].separate_multistem,
                                             member=fam["drum_kit"]))
    try:
        wav = work / "track.wav"
        write_wav(wav, x, SEP_SR)
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        body = {"files": [{"filename": "track.wav",
                           "content": base64.b64encode(wav.read_bytes()).decode()}],
                "settings": {"vocals_only": False, "separate_drums": True, "use_cache": False}}
        # the JAX processor's files: the ensemble's two stems, the 6-stem
        # split's others and the kit, each group in key order
        names = (["vocals", "instrumental"] + sorted(set(MULTISTEM_6) - {"vocals"})
                 + [f"drums_{k}" for k in sorted(DRUM_KIT)])
        want = [f"track ({k.title()}).wav" for k in names]
        try:
            resp, launches = timed("request", lambda: http(
                "POST", f"http://127.0.0.1:{port}/api/v1/process/separate", body))
        finally:
            server.shutdown()
            server.server_close()
        status, resp = resp
        expect(status == 200, f"separators: request HTTP {status} {resp.get('error')}")
        got = [f["filename"] for f in resp["files"]]
        expect(got == want, f"separators: request returned {got}, expected {want}")
        for f in resp["files"]:
            p = work / f"resp_{f['filename']}"
            p.write_bytes(base64.b64decode(f["content"]))
            a = read_wav(p)
            expect(a.samples.shape == (2, n) and bool(np.isfinite(a.samples).all()),
                   f"separators: {f['filename']} {a.samples.shape}")
        if expect_k1 is not None:
            check_launches(dev, launches, launches["K1_sm90"], expect_k1, 0,
                           "separators: request")
        rec["request_launches"] = launches
    finally:
        Separate.configure(None)
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # (e) one chunk, fp32 products, the card against the CPU; MDX23C's input
    # padded to its frame multiple as mdx23c_member pads it
    chunk = int(sep.chunk_seconds * SEP_SR)
    xc = audio[None, :, :chunk].float()
    models = fam["models"]
    good = models["mdx23c"].good_length(sep.chunk_seconds)
    runs = {"htdemucs": (models["htdemucs"], xc),
            "mdx23c": (models["mdx23c"], torch.nn.functional.pad(xc, (0, good - chunk))),
            "onnx": (lambda a: models["onnx"](a)["vocals"], xc)}
    rec["card_vs_cpu"] = {}
    with torch.inference_mode(), precision.matmul_precision("highest"):
        for name, (fn, inp) in runs.items():
            y = fn(inp)
            cpu_fn = fn if name == "onnx" else copy.deepcopy(fn).cpu()
            ref = cpu_fn(inp.cpu())
            err = float((y.cpu() - ref).abs().max()) / float(ref.abs().max())
            rec["card_vs_cpu"][name] = err
            expect(bool(torch.isfinite(y).all()) and err <= 1e-4,
                   f"separators: {name} on {dev.type} against the CPU: {err:.3e} of max|y|")
            del y, ref, cpu_fn
    log(f"[separators] (a) ensemble of {len(ens.members)} members "
        f"({', '.join(m.name for m in ens.members)}) on {n / SEP_SR:.1f} s: "
        f"{' / '.join(f'{t:.3f}' for t in rec['ensemble_s'])} s cold / warm, launches "
        f"{rec['ensemble_launches']}; alone, warm: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rec["member_s"].items())
        + " | (b) 6-stem HTDemucs "
        f"{' / '.join(f'{t:.3f}' for t in rec['multistem_s'])} s | (c) drum split "
        f"{' / '.join(f'{t:.3f}' for t in rec['drums_s'])} s | (d) POST "
        f"/api/v1/process/separate (vocals_only off, drums on; {len(want)} WAVs) "
        f"{' / '.join(f'{t:.3f}' for t in rec['request_s'])} s, launches "
        f"{rec['request_launches']} | (e) fp32 card vs CPU on one chunk, of max|y|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rec["card_vs_cpu"].items())
        + (f" | peak memory {rec['peak_mem_gb']:.2f} GB" if cuda else "") + f" | {card}")
    del fam, six, kit
    if cuda:
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- train

TRAIN_BATCH = 8          # the reference's train batch (tests/test_train_fullscale_shapes.py)
TRAIN_SAMPLES = 177600   # a 3.7 s slice at 48 kHz: 366 frames at n_fft 2048, hop 480
TRAIN_WARM = 15
TRAIN_TINY = dict(spec_channels=1025, segment_size=3840, inter_channels=16, hidden_channels=16,
                  filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
                  spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)
TRAIN_FILES = (10.0, 10.0, 10.0)    # the served job's dataset: seconds per file


def harmonic_tone(sr: int, n: int, f: float, seed: int) -> np.ndarray:
    """Five harmonics with a 5 Hz vibrato and a little noise (float32)."""
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(f * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / sr
    x = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def train_batch(dev, cfg, b: int, n: int, seed: int = 0) -> dict:
    """A batch as RVCDataLoader yields it: tones at 48 kHz, their magnitude
    spectrogram (center=False), YIN f0 of the same tones at 16 kHz and its
    coarse bins, seeded features of the config's width."""
    import torch

    from audiolab_tpu_torch.dsp.f0 import coarse_f0, f0_autocorr
    from audiolab_tpu_torch.kernels.stft import spectrogram
    from audiolab_tpu_torch.train.rvc import MEL_CFG

    m = MEL_CFG[cfg.sr]
    f = [110.0 + 25.0 * i for i in range(b)]
    wav = torch.from_numpy(np.stack([harmonic_tone(cfg.sr, n, f[i], seed + i)
                                     for i in range(b)])).to(dev)
    spec = spectrogram(wav, m["n_fft"], m["hop"], m["win_length"], center=False, power=1.0)
    t = spec.shape[1]
    x16 = torch.from_numpy(np.stack([harmonic_tone(16000, n * 16000 // cfg.sr, f[i], seed + i)
                                     for i in range(b)])).to(dev)
    f0 = f0_autocorr(x16, sr=16000, hop=160)[0][:, :t]
    feats = np.random.default_rng(seed).standard_normal((b, t, cfg.feat_channels))
    lengths = torch.full((b,), t, dtype=torch.long, device=dev)
    return dict(phone=torch.from_numpy(feats.astype(np.float32)).to(dev), phone_lengths=lengths,
                pitch=coarse_f0(f0), pitchf=f0, spec=spec, spec_lengths=lengths,
                wave=wav[:, : t * m["hop"]], sid=torch.zeros(b, dtype=torch.long, device=dev))


def train_step_check(dev, cfg, periods, b: int, n: int, label: str, card: str,
                     devices=("card",), reference: str = "cpu") -> list[dict]:
    """(b) One fp32 step of ``cfg`` on each of ``devices`` ("card", "cpu")
    against the same step in fp64 on ``reference``, same weights, batch
    (:func:`train_batch` of ``b`` x ``n`` samples) and draws, the
    reference's leaky ReLU sides and excitation phase replayed, through
    audiolab_tpu_torch/train/check.py (its gate and the three gradient
    readings: gated per tensor, each tensor's own max|g|, its block's)."""
    import torch

    from audiolab_tpu_torch.models.rvc.synthesizer import TrainDraws
    from audiolab_tpu_torch.train.check import GATE, step_against

    where = {"card": dev, "cpu": torch.device("cpu")}
    batch = train_batch(torch.device("cpu"), cfg, b, n)
    draws = TrainDraws.sample(cfg, b, batch["spec"].shape[1], torch.Generator().manual_seed(3))
    t0 = time.perf_counter()
    recs = step_against(cfg, batch, draws, [where[d] for d in devices], periods=periods,
                        reference=where[reference])
    sync(dev)
    secs = time.perf_counter() - t0
    out = []
    for name in devices:
        rec = recs[str(where[name])] | {"device": name, "reference": reference, "s": secs}
        log(f"[train] (b) {label}, batch {b} x {n} samples ({batch['spec'].shape[1]} frames), "
            f"one fp32 step on the {name} against the fp64 step on the {reference} (same "
            f"weights, batch, draws; replayed: {rec['flips']} leaky ReLU inputs on the other "
            f"side, phase {rec['phase_err']:.3e} cycles apart, bound {rec['phase_bound']:.3e}; "
            f"{secs:.1f} s for all): metrics {rec['metric_err']:.3e} relative (at "
            f"{rec['metric_at']}); gradients per tensor, a bias against its layer's weight "
            f"{rec['grad_err']:.3e} (at {rec['grad_at']}; gate {GATE:g}), against each "
            f"tensor's own max|g| {rec['grad_own_err']:.3e} (at {rec['grad_own_at']}), against "
            f"its block's {rec['grad_block_err']:.3e} (at {rec['grad_block_at']}); largest "
            f"share of its allowance {rec['grad_allowed_err']:.3f} (at "
            f"{rec['grad_allowed_at']}) | {card}")
        expect(rec["ok"], f"train: {label}, {name} against the fp64 step")
        out.append(rec)
    torch.cuda.empty_cache()
    return out


def phase_train(dev, card: str, synth_kw: dict | None = None, periods=None,
                batch: int = TRAIN_BATCH, samples: int = TRAIN_SAMPLES, warm: int = TRAIN_WARM,
                files=TRAIN_FILES, settings: dict | None = None,
                convert_s: float = 10.0) -> dict:
    """RVC training on the card.  (a) the train step at full v2-48k width
    with the full multi-period discriminator, batch 8 of 3.7 s: the cold
    first step, ``warm`` warm steps, the six losses, peak memory, no kernel
    launched; (b) one fp32 step against an fp64 one: the tiny
    configuration on the card and on the CPU, the phase's configuration at
    batch 1 on the card; (c) the
    served path: POST /api/v1/rvc/train on a seeded dataset (full HuBERT, 2
    epochs), /rvc/resume (3 epochs), /rvc/build_index, and the trained
    model converting 10 s through a VoiceConverter.  Counts are
    reset just before (a) and (c) and read just after; returns the counts
    of the training path (the jobs' feature extraction launches fp32 K2)."""
    import base64
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.models.rvc.synthesizer import (
        SynthesizerConfig,
        SynthesizerTrn,
        config_for,
    )
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.train.checkpoint import load_generator
    from audiolab_tpu_torch.train.rvc import create_train_state, make_train_step
    from audiolab_tpu_torch.train.rvc_train import _hubert_apply_for
    from audiolab_tpu_torch.utils.weights import synthesizer_from_jax

    cuda = dev.type == "cuda"
    rec: dict = {}
    cfg = SynthesizerConfig(**synth_kw) if synth_kw else config_for(48000, "v2")

    # (a) the step at full width
    t0 = time.perf_counter()
    state, _, _ = create_train_state(cfg, seed=0, periods=periods, device=dev)
    sync(dev)
    rec["state_s"] = time.perf_counter() - t0
    data = train_batch(dev, cfg, batch, samples)
    step = make_train_step(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(1 + warm):
        t0 = time.perf_counter()
        state, metrics = step(state, data, 0)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = counts()
    rec["cold_step_s"], warm_s = times[0], times[1:]
    rec["warm_step_s"] = float(np.median(warm_s))
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    n_params = sum(p.numel() for p in (*state.gen.parameters(), *state.disc.parameters()))
    mel = [m["loss_mel"] for m in losses]
    log(f"[train] (a) step at {'v2-48k' if not synth_kw else 'a small config'}, "
        f"{len(state.disc.discriminators)} discriminators, batch {batch} x {samples} samples "
        f"({data['spec'].shape[1]} frames, segment {cfg.segment_size}), "
        f"{n_params / 1e6:.1f} M parameters: state built in {rec['state_s']:.3f} s, cold step "
        f"{rec['cold_step_s']:.3f} s, warm median {rec['warm_step_s']:.4f} s (min "
        f"{min(warm_s):.4f}, max {max(warm_s):.4f}, {len(warm_s)} steps)"
        + (f", peak memory {rec['peak_mem_gb']:.2f} GB" if cuda else "")
        + f" | first {losses[0]} | last {losses[-1]} | loss_mel "
        + " ".join(f"{v:.3f}" for v in mel) + f" | launches {launches} | {card}")
    expect(all(np.isfinite(v) for m in losses for v in m.values()), "train: a loss is not finite")
    expect(state.step == 1 + warm, f"train: step {state.step}, expected {1 + warm}")
    expect(float(np.mean(mel[-3:])) < float(np.mean(mel[:3])),
           f"train: loss_mel did not fall on the fixed batch ({mel[:3]} -> {mel[-3:]})")
    expect(all(v == 0 for v in launches.values()), f"train: the step launched {launches}")
    del state, data, step
    if cuda:
        torch.cuda.empty_cache()

    # (b) the fp32 step against an fp64 one: the small configuration on the
    # card and on the CPU against the CPU's; the full width at batch 1 (49
    # frames, one segment of 36) on the card against the card's (an fp64
    # step is exact far below the gate on either device; the card takes a
    # second for it)
    if cuda:
        rec["card_vs_fp64"] = [
            *train_step_check(dev, SynthesizerConfig(**TRAIN_TINY), (2, 3), 2, 7680 + 2048,
                              "tiny config, periods (2, 3)", card, devices=("card", "cpu")),
            *train_step_check(dev, cfg, periods, 1, 48 * 480 + 2048,
                              "v2-48k" if not synth_kw else "the phase's config", card,
                              reference="card")]

    # (c) the served path
    settings = dict(settings or {"small_hubert": False}, epochs=2)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    server = None
    try:
        payload = []
        for i, secs in enumerate(files):
            wav = work / f"take{i}.wav"
            write_wav(wav, harmonic_tone(48000, int(secs * 48000), 120.0 + 40 * i, 10 + i), 48000)
            payload.append({"filename": wav.name,
                            "content": base64.b64encode(wav.read_bytes()).decode()})
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        url = f"http://127.0.0.1:{port}/api/v1/rvc"
        exp = work / "models" / "exp" / "voice"
        rec["jobs"] = []
        train_launches = dict.fromkeys(KERNELS, 0)
        for route, body in (("train", {"files": payload, "name": "voice", "settings": settings}),
                            ("resume", {"name": "voice", "settings": settings | {"epochs": 3}})):
            before = (json.loads((exp / "train_state.json").read_text())["step"]
                      if route == "resume" else 0)
            reset_counts()
            t0 = time.perf_counter()
            status, resp = http("POST", f"{url}/{route}", body)
            expect(status == 200, f"train: POST rvc/{route}: HTTP {status} {resp}")
            while True:
                time.sleep(0.5)
                status, job = http("GET", f"{url}/job/{resp['job_id']}")
                if job.get("status") != "running":
                    break
            secs = time.perf_counter() - t0
            launches = counts()
            expect(job.get("status") == "done", f"train: rvc/{route} job {job}")
            slices = len(list((exp / "16k_wavs").glob("*.wav")))
            groups = -(-slices // 8)
            after = json.loads((exp / "train_state.json").read_text())["step"]
            steps_per_epoch = slices // int(settings.get("batch_size", 4))
            log(f"[train] (c) POST rvc/{route}: {len(files)} files, {sum(files):.1f} s, "
                f"{slices} slices, {groups} feature groups, steps {before} -> {after}, job "
                f"{secs:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                              job["result"]["seconds"].items())
                + f" | metrics {job['result']['metrics']} | launches {launches} | {card}")
            if cuda:
                expect(only(launches, "K2", HUBERT_LAYERS * groups),
                       f"train: rvc/{route} launches {launches}, expected K2 "
                       f"{HUBERT_LAYERS * groups} and no other")
            want = steps_per_epoch * (2 if route == "train" else 1)
            expect(after - before == want, f"train: rvc/{route} took {after - before} steps, "
                                           f"expected {want}")
            for k in KERNELS:
                train_launches[k] += launches[k]
            rec["jobs"].append({"route": route, "s": secs, "stages_s": job["result"]["seconds"]})
        status, models = http("GET", f"{url}/models")
        expect({"voice.npz", "voice.index.npz"} <= set(models["models"]),
               f"train: rvc/models {models}")
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/build_index", {"name": "voice"})
        expect(status == 200, f"train: POST rvc/build_index: HTTP {status} {resp}")
        index = np.load(resp["index"])["features"]
        log(f"[train] (c) POST rvc/build_index: {index.shape} in "
            f"{time.perf_counter() - t0:.3f} s")

        tree, mcfg = load_generator(str(work / "models" / "rvc" / "voice.npz"))
        synth = SynthesizerTrn(mcfg)
        synth.load_state_dict(synthesizer_from_jax(tree), strict=True)
        vc = VoiceConverter(synth, _hubert_apply_for(settings, dev), index_features=index,
                            cfg=RVCPipelineConfig(sr=mcfg.sr, f0_method="yin"), device=dev)
        x16 = torch.from_numpy(harmonic_tone(16000, int(convert_s * 16000), 180.0, 30)).to(dev)
        t0 = time.perf_counter()
        out = vc.convert(x16, sid=0, seed=0, as_numpy=False)
        sync(dev)
        want = int(round(x16.shape[-1] * mcfg.sr / RVC_SR))
        finite = bool(torch.isfinite(out).all())
        log(f"[train] (c) the trained voice.npz through VoiceConverter (yin, retrieval on): "
            f"{convert_s:.1f} s -> {tuple(out.shape)} at {mcfg.sr} Hz (expected {want}), finite "
            f"{finite}, peak {float(out.abs().max()):.4f}, {time.perf_counter() - t0:.3f} s")
        expect(tuple(out.shape) == (want,) and finite, "train: converted output")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    rec["train_launches"] = train_launches
    return rec


# ---------------------------------------------------------------- main

TTS_TEXT = ("Welcome back to the studio, everyone. [happiness] Today we are recording the "
            "vocals for our brand new song! It is going to sound wonderful.")
TTS_FRAME_HZ = 44100 / 512          # DAC frames a second of audio
TTS_WARM = 2
TTS_DAC_FRAMES = 50                 # frames of the card-against-CPU DAC check


def build_tts(dev, mixer: str):
    """ZonosTTS at ZonosConfig()'s published backbone widths (dim 1024, 12
    layers, attention every 6th, 16 x 64 heads, 9 codebooks x 1026) with the
    44.1 kHz DAC that load_dac_checkpoint builds (decoder_dim 1536, rates 8,
    8, 4, 2), weights by bench.py's rules from seed 0."""
    from audiolab_tpu_torch.models.codecs import DACConfig
    from audiolab_tpu_torch.models.zonos import ZonosConfig
    from audiolab_tpu_torch.pipelines.tts import random_zonos

    return random_zonos(ZonosConfig(mixer=mixer), seed=0,
                        dac_cfg=DACConfig(decoder_dim=1536), device=dev)


def phase_tts(dev, card: str, profile_dir: str | None = None) -> dict:
    """Zonos TTS on the card, for each mixer (mamba1, and the upstream
    hybrid's mamba2).  (a) ``ZonosTTS.synthesize`` on a three-sentence text
    with one emotion tag (3 chunks, CFG batch 6): a cold call and
    TTS_WARM warm ones (every call captures its own decode step), each with
    counts reset just before and read just after (2 K2 launches, the fp32
    kernel, nothing else), seconds of prefill, decode and DAC, steps/s,
    audio-s/s, peak memory and the memory still held after the call, the
    waveform's length and finiteness; (b) the captured decode against the
    eager loop under the same draws: identical codes; the first chunk's
    first TTS_DAC_FRAMES frames of those codes through the DAC on the card
    and on a CPU copy: within 1e-5 of max|y|; then the card's fp32 logits
    against the CPU's for the prefill and 8 teacher-forced steps (CFG batch
    2): within 1e-4 of max|logit|.  (c) with
    the mamba2 model: POST /api/v1/audio/speech through create_app on the
    card: HTTP 200, a 44.1 kHz WAV of the synthesized length, the download
    route, K2 2.  With ``profile_dir``, a profiler table of one warm call of
    each mixer.  Returns the counts of the first call and of the request."""
    import base64
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.core.audio_io import read_wav
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.models.codecs import DACDecoder
    from audiolab_tpu_torch.models.zonos import ZonosModel, generate, gumbel_draws
    from audiolab_tpu_torch.pipelines.tts import parse_emotion_chunks
    from audiolab_tpu_torch.serve import tts_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    cuda = dev.type == "cuda"
    rec: dict = {"runs": {}}
    for mixer in ("mamba1", "mamba2"):
        t0 = time.perf_counter()
        tts = build_tts(dev, mixer)
        sync(dev)
        c = tts.model.cfg
        n_params = sum(p.numel() for p in tts.model.parameters())
        dac_params = sum(p.numel() for p in tts.dac.parameters())
        log(f"[tts] {mixer}: Zonos dim {c.dim}, {c.n_layers} layers (attention every "
            f"{c.attn_every}), {n_params / 1e6:.1f} M parameters; DAC decoder_dim "
            f"{tts.dac.cfg.d0}, {dac_params / 1e6:.1f} M; built in "
            f"{time.perf_counter() - t0:.1f} s")
        chunks = parse_emotion_chunks(TTS_TEXT)
        n = len(chunks)
        ids, emotions, frames = tts.encode_text(chunks)
        sil = int(tts.cfg.silence_ms / 1000.0 * tts.cfg.sr)
        want_len = n * frames * tts.dac.cfg.hop + (n - 1) * sil
        runs = []
        for i in range(1 + TTS_WARM):
            label = f"tts {mixer} call {i + 1} ({'cold' if i == 0 else 'warm'})"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated() if cuda else 0
            reset_counts()
            t0 = time.perf_counter()
            audio, sr = tts.synthesize(TTS_TEXT, seed=i, timed=True)
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            k2_hopper = A.flash_attention_fwd.sm90_launches
            st = dict(tts.last_stats)
            peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
            held = (torch.cuda.memory_allocated() - before) / 1e6 if cuda else float("nan")
            steps_s = st["steps"] / st["decode_s"]
            run = dict(seconds=secs, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                       dac_s=st["dac_s"], draws_s=st["draws_s"], steps=st["steps"],
                       steps_per_s=steps_s, decode_audio_s_per_s=n * steps_s / TTS_FRAME_HZ,
                       audio_s_per_s=len(audio) / sr / secs, peak_gb=peak, held_mb=held,
                       launches=launches)
            runs.append(run)
            log(f"[tts] {label}: {n} chunks, {frames} frames + {c.n_codebooks} delay steps, "
                f"CFG batch {2 * n}: {secs:.3f} s (draws {st['draws_s']:.3f}, prefill "
                f"{st['prefill_s']:.3f}, decode {st['decode_s']:.3f}, DAC {st['dac_s']:.3f}); "
                f"{steps_s:.1f} steps/s = {run['decode_audio_s_per_s']:.2f} audio-s/s of "
                f"decode, {run['audio_s_per_s']:.2f} audio-s/s end to end "
                f"({len(audio) / sr:.2f} s of audio at {sr} Hz); peak {peak:.2f} GB, "
                f"{held:.1f} MB held after the call; "
                f"peak |y| {float(np.abs(audio).max()):.4f}; launches {launches} (K2 on the "
                f"Hopper design: {k2_hopper}) | {card}")
            expect(sr == 44100 and audio.shape == (want_len,) and bool(np.isfinite(audio).all()),
                   f"{label}: {audio.shape} at {sr} Hz, expected ({want_len},) at 44100, finite")
            expect(only(launches, "K2", 2) and k2_hopper == 0,
                   f"{label}: launches {launches}, {k2_hopper} on the Hopper design; "
                   "expected 2 fp32 K2 (k2f_kernel) and no other")
        rec["runs"][mixer] = runs
        if mixer == "mamba1":
            rec["launches"] = runs[0]["launches"]
        if profile_dir and cuda:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tts.synthesize(TTS_TEXT, seed=1, timed=True)
                sync(dev)
            st = tts.last_stats
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            device_s = sum(e.self_device_time_total for e in kernels) / 1e6
            wall = st["prefill_s"] + st["decode_s"] + st["dac_s"]
            path = Path(profile_dir) / f"chip_smoke_tts_{mixer}_profile.txt"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(f"{card}\nwarm synthesize ({mixer}): prefill {st['prefill_s']:.3f} "
                            f"s, decode {st['decode_s']:.3f} s, DAC {st['dac_s']:.3f} s; "
                            f"{device_s:.3f} s of device time\n"
                            + events.table(sort_by="self_cuda_time_total", row_limit=40) + "\n")
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            rec.setdefault("profile", {})[mixer] = dict(device_s=device_s, wall_s=wall)
            log(f"[tts] {mixer} profiler, one warm call: {device_s:.3f} s of device time in "
                f"{wall:.3f} s of stages ({device_s / wall:.0%} busy); top kernels: "
                + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x {e.count}"
                            for e in top) + f" -> {path}")

        # (b) the captured step against the eager loop, the same draws
        total = frames + c.n_codebooks
        spk = np.zeros((n, c.spk_dim), np.float32)
        draws = gumbel_draws(total, n * c.n_codebooks, c.vocab, 7, dev)
        kw = dict(max_frames=frames, emotion=emotions, rate=np.full((n, 1), 15.0, np.float32),
                  pitch=np.full((n, 1), 20.0, np.float32), draws=draws, device=dev)
        codes = {}
        for graph in ((True, False) if cuda else (False,)):
            t0 = time.perf_counter()
            codes[graph] = generate(tts.model, ids, spk, graph=graph, **kw)
            sync(dev)
            log(f"[tts] {mixer}: generate with graph={graph}: {time.perf_counter() - t0:.3f} s "
                f"({total} steps)")
        if cuda:
            same = torch.equal(codes[True], codes[False])
            log(f"[tts] {mixer}: captured decode against the eager loop, the same draws: "
                f"codes {'identical' if same else 'DIFFER'} "
                f"({int((codes[True] != codes[False]).sum())} of {codes[True].numel()} differ)")
            expect(same, f"tts {mixer}: graph and eager decode codes differ")

        # the DAC on the card against a CPU copy, on a slice of those codes
        part = torch.clamp(codes[cuda][:1, :, :TTS_DAC_FRAMES], 0, c.codebook_size - 3)
        cpu_dac = DACDecoder(tts.dac.cfg)
        cpu_dac.load_state_dict({k: v.cpu() for k, v in tts.dac.state_dict().items()})
        ys = {}
        for name, dac, d in (("cpu", cpu_dac.eval(), torch.device("cpu")), ("card", tts.dac, dev)):
            t0 = time.perf_counter()
            with torch.inference_mode():
                ys[name] = dac(part.to(d)).cpu()
            log(f"[tts] {mixer}: DAC on the {name}, {TTS_DAC_FRAMES} frames -> "
                f"{ys[name].shape[-1]} samples: {time.perf_counter() - t0:.3f} s")
        del cpu_dac, codes, draws
        err = float((ys["card"] - ys["cpu"]).abs().max())
        scale = float(ys["cpu"].abs().max())
        rec.setdefault("dac_card_vs_cpu", {})[mixer] = err / scale
        log(f"[tts] {mixer}: DAC card against CPU, fp32: max err {err:.3e} = "
            f"{err / scale:.3e} of max|y| {scale:.4f} (tol 1e-5)")
        expect(bool(torch.isfinite(ys["card"]).all()) and 0 < scale and err <= 1e-5 * scale,
               f"tts {mixer}: card DAC {err / scale:.3e} of max|y| from the CPU's")

        # card against CPU: prefill (chunk 1 at the full text length, CFG
        # batch 2) and teacher-forced steps, fp32
        cpu_model = ZonosModel(c)
        cpu_model.load_state_dict({k: v.cpu() for k, v in tts.model.state_dict().items()})
        cpu_model.eval()
        rng = np.random.default_rng(3)
        forced = rng.integers(0, c.codebook_size - 2, (8, 2, c.n_codebooks))
        seq = {}
        for name, model, d in (("cpu", cpu_model, torch.device("cpu")), ("card", tts.model, dev)):
            tid = torch.as_tensor(np.concatenate([ids[:1], 0 * ids[:1]]), dtype=torch.long,
                                  device=d)
            em = torch.as_tensor(np.concatenate([emotions[:1]] * 2), device=d)
            bos = torch.full((2, c.n_codebooks, 1), c.masked_id, dtype=torch.long, device=d)
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, states, plen = model.prefill(
                    tid, torch.zeros((2, c.spk_dim), device=d), em,
                    torch.full((2, 1), 15.0, device=d), torch.full((2, 1), 20.0, device=d),
                    bos, ids.shape[1] + 5 + len(forced) + 2)
                out = [logits]
                for i, ct in enumerate(forced):
                    out.append(model.decode_step(torch.as_tensor(ct, device=d),
                                                 torch.tensor([plen + i], device=d), states))
            seq[name] = torch.stack(out).cpu()
            log(f"[tts] {mixer}: teacher-forced prefill ({plen} positions) + {len(forced)} "
                f"steps on the {name}: {time.perf_counter() - t0:.3f} s")
        del cpu_model
        err = float((seq["card"] - seq["cpu"]).abs().max())
        scale = float(seq["cpu"].abs().max())
        rec.setdefault("card_vs_cpu", {})[mixer] = err / scale
        log(f"[tts] {mixer}: card against CPU, fp32 logits: max err {err:.3e} = "
            f"{err / scale:.3e} of max|logit| {scale:.3f} (tol 1e-4)")
        expect(err <= 1e-4 * scale, f"tts {mixer}: card logits {err / scale:.3e} of max from "
               "the CPU's")

        if mixer == "mamba2":
            # (c) the speech route through create_app on the card
            work = Path(tempfile.mkdtemp(prefix="chip_smoke_tts_"))
            saved = dict(tts_api._BACKENDS)
            server, port = serve_background(create_app(str(work / "process"), device=dev))
            try:
                tts_api.register_backend("zonos", tts)
                reset_counts()
                t0 = time.perf_counter()
                status, resp = http("POST", f"http://127.0.0.1:{port}/api/v1/audio/speech",
                                    {"model": "zonos", "input": TTS_TEXT})
                sync(dev)
                secs = time.perf_counter() - t0
                launches = counts()
                expect(status == 200, f"tts request: HTTP {status} {resp.get('error')}")
                wav = work / "speech.wav"
                wav.write_bytes(base64.b64decode(resp["audio"]))
                a = read_wav(wav)
                expect(a.sample_rate == 44100 and a.samples.shape == (1, want_len)
                       and bool(np.isfinite(a.samples).all()),
                       f"tts request: {a.samples.shape} at {a.sample_rate} Hz, expected "
                       f"(1, {want_len}) at 44100")
                dl = urllib_get(f"http://127.0.0.1:{port}/api/v1/audio/speech/download/"
                                f"{resp['file_id']}")
                expect(dl == wav.read_bytes(), "tts request: the download differs")
                expect(only(launches, "K2", 2),
                       f"tts request: launches {launches}, expected K2 2")
                rec["request_s"], rec["served_launches"] = secs, launches
                log(f"[tts] POST /api/v1/audio/speech (mamba2, {n} sentences): HTTP {status} "
                    f"{secs:.3f} s; WAV {a.sample_rate} Hz x {a.samples.shape[1]} samples "
                    f"({a.samples.shape[1] / a.sample_rate:.2f} s, {wav.stat().st_size / 1e6:.2f}"
                    f" MB); download OK; launches {launches} | {card}")
            finally:
                server.shutdown()
                server.server_close()
                tts_api._BACKENDS.clear()
                tts_api._BACKENDS.update(saved)
                shutil.rmtree(work, ignore_errors=True)
        del tts
        if cuda:
            torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------- engines

DIA_TEXT = ("[S1] Welcome back to the studio, everyone. [S2] Thanks! Today we are recording "
            "the vocals for our brand new song. [S1] It is going to sound wonderful.")
DIA_WARM = 2
DIA_GRAPH_FRAMES = 64            # frames of the captured-against-eager check
DIA_PROMPT_FRAMES = 431          # a 5 s audio prompt of 44.1 kHz DAC frames (hop 512)
DIA_PROMPT_DECODE = 86           # frames decoded after the prompt (1 s)
# Dia-1.6B's published decoder geometry as far as DiaConfig expresses it (the
# JAX DiaEncoder has no head-dim field: its attention is 8 x 128 where the
# published encoder's is 16 x 128)
DIA16 = dict(dim_dec=2048, n_layers_dec=18, n_heads=16, kv_heads=4, head_dim_dec=128,
             cross_head_dim=128, dim_enc=1024, n_layers_enc=12, n_heads_enc=8,
             max_audio_len=3072)
XTTS_TEXT = "Welcome back to the studio. Today we record the vocals for our new song."
XTTS_REF_S = 6.0
XTTS_STEPS = 200
ZONOS_EMB_FRAMES = 200
LM_TOKENS = 2048


def build_dia(dev, seed: int = 0, **cfg_kw):
    """Dia at ``DiaConfig(**cfg_kw)`` on ``dev``, weights by bench.py's rules."""
    import torch

    from audiolab_tpu_torch.models.dia import DiaConfig, DiaModel
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(DiaModel(DiaConfig(**cfg_kw)), seed).eval()


def build_dac(dev, seed: int = 1):
    """The 44.1 kHz DAC decoder (decoder_dim 1536) Dia and Zonos decode
    through, on ``dev``."""
    import torch

    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(DACDecoder(DACConfig(decoder_dim=1536)), seed).eval()


def build_xtts_v2(dev, seed: int = 10):
    """XTTS-v2's five weighted modules at the published widths on ``dev``, in
    ``XttsCheckpointEngine``'s order (GPT-2, conditioning encoder, perceiver,
    speaker encoder, HiFi decoder), seeded ``seed`` to ``seed + 4``."""
    import torch

    from audiolab_tpu_torch.models.xtts import (
        XttsConditioningEncoder,
        XttsGPT2,
        XttsHifiganDecoder,
        XttsPerceiverResampler,
        XttsSpeakerEncoder,
    )
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return [fast_init(m, seed + i).eval() for i, m in enumerate((
            XttsGPT2(), XttsConditioningEncoder(), XttsPerceiverResampler(),
            XttsSpeakerEncoder(), XttsHifiganDecoder()))]


def _peak_reset(cuda: bool) -> None:
    import torch

    if cuda:
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(cuda: bool) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")


def _tone(seconds: float, sr: int) -> np.ndarray:
    """A seeded harmonic tone with vibrato and a little noise: the references."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = 180.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / k * np.sin(k * ph) for k in range(1, 6))
    x += 0.01 * np.random.default_rng(5).standard_normal(len(t))
    return (0.5 * x).astype(np.float32)


def profile_call(label: str, fn, wall_stages: dict, dev, profile_dir: str, card: str,
                 tag: str = "[engines]") -> dict:
    """One call of ``fn`` under torch.profiler: a table of its device time by
    kernel in ``profile_dir``, and a log line with the device time, the
    share of the stages' wall time it fills and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    wall = sum(wall_stages.values())
    name = re.sub(r"[^a-z0-9]+", "_", label.lower()).strip("_")
    path = Path(profile_dir) / f"chip_smoke_{name}_profile.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{card}\n{label}: stages {wall_stages}; {device_s:.3f} s of device time, "
                    f"{launches} kernel launches\n"
                    + events.table(sort_by="self_cuda_time_total", row_limit=40) + "\n")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"{tag} profile {label}: {device_s:.3f} s of device time in {wall:.3f} s of "
        f"stages ({device_s / wall:.0%} busy), {launches} kernel launches; top: "
        + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ms x {e.count}"
                    for e in top) + f" -> {path}")
    return dict(device_s=device_s, wall_s=wall, launches=launches)


def phase_engines(dev, card: str, profile_dir: str | None = None) -> dict:
    """The speech engines of the LM core on the card, weights by bench.py's
    rules (utils/fast_init.py).  (a) Dia at DiaConfig() (decoder 1024 x 12,
    16 x 64 heads; encoder 512 x 6) through DiaTTSEngine with the 44.1 kHz
    DAC (decoder_dim 1536) on a two-speaker line of 27 words: a cold call and
    DIA_WARM warm ones, 12 fp32 K2 a call (counts reset just before, read
    just after), seconds by stage, steps/s, peak memory, finite audio; the
    captured decode against the eager loop under the same draws (identical
    codes); the code-range repair on ids past the DAC.  (b) Dia with a 5 s
    audio prompt (431 frames, prefill 441 positions) at DiaConfig() and at
    Dia-1.6B's decoder geometry (18 fp32 K2 at d = 128), and one
    teacher-forced DiaModel forward over the prompt.  (c) the capability XTTS
    at XTTSConfig() and the demo random_xtts(), each ``tts`` on a 6 s
    reference.  (d) XTTS-v2 at its published widths: ``conditioning`` on a 6 s
    reference, ``synthesize`` for 200 steps, seconds by stage, steps/s, peak
    memory; the cached decode's logits against one full re-forward on the
    card.  (e) Zonos ``generate_embedded`` at ZonosConfig() from a
    ZonosPrefixConditioner prefix over phoneme ids (2 fp32 K2).  (f)
    TransformerLM at LMConfig() (bf16): one uncached forward over 2,048
    tokens, 16 16-bit K2 on the Hopper route.  (g) POST /api/v1/audio/speech
    with "dia" and "coqui", and ``main --demo-backends`` answering a "coqui"
    request.  (h) the card against the CPU in fp32: Dia's logits, XTTS-v2's
    latents and HiFi waveform, the prefix conditioner's output.  With
    ``profile_dir``, profiler tables of one warm Dia call and one warm XTTS-v2
    synthesize.  Returns the path's counts: (a)'s first call plus (f)'s first
    warm forward."""
    import base64
    import shutil
    import signal
    import socket
    import tempfile
    import urllib.error

    import torch

    from audiolab_tpu_torch.core.audio_io import read_wav
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.models.dia import DiaConfig, DiaModel, tokenize_dialogue
    from audiolab_tpu_torch.models.dia import generate as dia_generate
    from audiolab_tpu_torch.models.lm import LMConfig, TransformerLM, gumbel_draws
    from audiolab_tpu_torch.models.phonemize import phonemize_ipa
    from audiolab_tpu_torch.models.xtts import (
        XTTS,
        XTTSConfig,
        XttsGPT2,
        XttsHifiganDecoder,
        xtts_gpt2_generate,
    )
    from audiolab_tpu_torch.models.zonos import (
        DEFAULT_ZONOS_CONDITIONERS,
        ZonosPrefixConditioner,
        delay_pattern,
        generate_embedded,
        tokenize_phonemes_np,
    )
    from audiolab_tpu_torch.pipelines.tts import DiaTTSEngine, XttsCheckpointEngine, random_xtts
    from audiolab_tpu_torch.serve import tts_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)

    def n_params(m) -> float:
        return sum(p.numel() for p in m.parameters()) / 1e6

    def cpu_copy(module, make):
        c = make()
        c.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
        return c.eval()

    # (a) Dia at DiaConfig() behind DiaTTSEngine
    t0 = time.perf_counter()
    dia, dac = build_dia(dev), build_dac(dev)
    eng = DiaTTSEngine(dia, dac, device=dev)
    sync(dev)
    c = dia.cfg
    frames = eng.frames(DIA_TEXT)
    log(f"[engines] (a) Dia DiaConfig(): decoder {c.dim_dec} x {c.n_layers_dec}, "
        f"{c.n_heads} x {c.dim_dec // c.n_heads} heads, encoder {c.dim_enc} x "
        f"{c.n_layers_enc}, {n_params(dia):.1f} M parameters; DAC {n_params(dac):.1f} M; "
        f"built in {time.perf_counter() - t0:.1f} s")
    runs = []
    for i in range(1 + DIA_WARM):
        label = f"dia call {i + 1} ({'cold' if i == 0 else 'warm'})"
        _peak_reset(cuda)
        reset_counts()
        t0 = time.perf_counter()
        audio, sr = eng.generate(DIA_TEXT, seed=i, timed=True)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        hop = A.flash_attention_fwd.sm90_launches
        st = dict(eng.last_stats)
        run = dict(seconds=secs, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                   dac_s=st["dac_s"], steps=st["steps"],
                   steps_per_s=st["steps"] / st["decode_s"], peak_gb=_peak_gb(cuda),
                   audio_s=len(audio) / sr, launches=launches)
        runs.append(run)
        log(f"[engines] (a) {label}: {frames} frames + {c.n_codebooks} delay steps, CFG batch "
            f"2: {secs:.3f} s (draws {st['draws_s']:.3f}, prefill {st['prefill_s']:.3f}, "
            f"decode {st['decode_s']:.3f}, DAC {st['dac_s']:.3f}); {run['steps_per_s']:.1f} "
            f"steps/s; {run['audio_s']:.2f} s of audio at {sr} Hz, "
            f"{run['audio_s'] / secs:.2f} audio-s/s; peak {run['peak_gb']:.2f} GB; launches "
            f"{launches} (K2 on the Hopper design: {hop}) | {card}")
        expect(sr == 44100 and audio.shape == (frames * dac.cfg.hop,)
               and bool(np.isfinite(audio).all()),
               f"{label}: {audio.shape} at {sr} Hz, expected ({frames * dac.cfg.hop},), finite")
        expect(only(launches, "K2", c.n_layers_dec) and hop == 0,
               f"{label}: launches {launches}, {hop} Hopper; expected {c.n_layers_dec} fp32 K2")
        if i == 0:
            for k in path:
                path[k] += launches[k]
    rec["dia"] = runs
    if profile_dir and cuda:
        rec["dia_profile"] = profile_call(
            "Dia DiaConfig() warm generate", lambda: eng.generate(DIA_TEXT, seed=1, timed=True),
            {k: runs[-1][k] for k in ("prefill_s", "decode_s", "dac_s")}, dev, profile_dir, card)
    ids = tokenize_dialogue(DIA_TEXT)[None]
    draws = gumbel_draws(DIA_GRAPH_FRAMES + c.n_codebooks, c.n_codebooks, c.codebook_size, 7,
                         dev)
    codes = {}
    for graph in ((True, False) if cuda else (False,)):
        t0 = time.perf_counter()
        codes[graph] = dia_generate(dia, ids, max_frames=DIA_GRAPH_FRAMES, draws=draws,
                                    graph=graph, device=dev)
        sync(dev)
        log(f"[engines] (a) Dia generate graph={graph}: {time.perf_counter() - t0:.3f} s "
            f"({DIA_GRAPH_FRAMES + c.n_codebooks} steps)")
    if cuda:
        same = torch.equal(codes[True], codes[False])
        log(f"[engines] (a) captured decode against the eager loop, the same draws: codes "
            f"{'identical' if same else 'DIFFER'}")
        expect(same, "dia: graph and eager decode codes differ")
    gen = codes[cuda]
    past = int((gen >= dac.cfg.codebook_size).sum())
    y = eng.codes_to_audio(torch.cat([gen, torch.full_like(gen, c.eos_id)]))
    sync(dev)
    log(f"[engines] (a) code-range repair: {past} generated ids past the DAC's "
        f"{dac.cfg.codebook_size} rows, and a row of EOS ids: audio finite "
        f"{bool(torch.isfinite(y).all())}, no device assert")
    expect(bool(torch.isfinite(y).all()), "dia: the repaired codes gave non-finite audio")
    del codes, gen, draws, y

    # (b) a 5 s audio prompt, at DiaConfig() and at Dia-1.6B's decoder geometry
    g = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, 1024, (1, 9, DIA_PROMPT_FRAMES), generator=g, device=dev)
    rec["prompt"] = {}
    for name, cfg_kw in (("DiaConfig()", {}), ("Dia-1.6B geometry", DIA16)):
        if cfg_kw:
            del eng, dia
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            dia = build_dia(dev, 2, **cfg_kw)
            sync(dev)
            log(f"[engines] (b) {name}: {n_params(dia):.1f} M parameters "
                f"({4 * n_params(dia) / 1e3:.2f} GB fp32), built in "
                f"{time.perf_counter() - t0:.1f} s")
        c = dia.cfg
        runs = []
        for i in range(2):
            st: dict = {}
            _peak_reset(cuda)
            reset_counts()
            t0 = time.perf_counter()
            out = dia_generate(dia, ids, max_frames=DIA_PROMPT_DECODE, audio_prompt=prompt,
                               seed=i, stats=st, device=dev)
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            run = dict(seconds=secs, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                       steps=st["steps"], steps_per_s=st["steps"] / st["decode_s"],
                       peak_gb=_peak_gb(cuda), launches=launches)
            runs.append(run)
            log(f"[engines] (b) {name} generate with the prompt, call {i + 1}: prefill "
                f"{1 + DIA_PROMPT_FRAMES + c.n_codebooks} positions {st['prefill_s']:.3f} s, "
                f"decode {st['steps']} steps {st['decode_s']:.3f} s = "
                f"{run['steps_per_s']:.1f} steps/s; {secs:.3f} s; peak {run['peak_gb']:.2f} "
                f"GB; launches {launches} (Hopper {A.flash_attention_fwd.sm90_launches}) | "
                f"{card}")
            expect(tuple(out.shape) == (1, c.n_codebooks, DIA_PROMPT_DECODE),
                   f"dia prompt {name}: codes {tuple(out.shape)}")
            expect(only(launches, "K2", c.n_layers_dec)
                   and A.flash_attention_fwd.sm90_launches == 0,
                   f"dia prompt {name}: launches {launches}; expected {c.n_layers_dec} fp32 K2")
        bos = torch.full((1, c.n_codebooks, 1), c.bos_id, dtype=torch.long, device=dev)
        seq = torch.cat([bos, delay_pattern(prompt, c.masked_id)], dim=2)
        text = torch.as_tensor(ids, dtype=torch.long, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = dia(text, seq, text != 0)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        log(f"[engines] (b) {name} teacher-forced forward over {seq.shape[2]} positions: "
            f"{secs:.3f} s, logits {tuple(logits.shape)} finite "
            f"{bool(torch.isfinite(logits).all())}; launches {launches}")
        expect(bool(torch.isfinite(logits).all()) and only(launches, "K2", c.n_layers_dec),
               f"dia forward {name}: launches {launches}")
        rec["prompt"][name] = dict(runs=runs, forward_s=secs, params_m=n_params(dia))
        del out, logits
    del dia
    torch.cuda.empty_cache()

    # (c) the capability XTTS
    ref24 = _tone(XTTS_REF_S, 24000)
    demo = random_xtts(device=dev)
    rec["xtts"] = {}
    for name, model in (("XTTSConfig()", XTTS.random_init(XTTSConfig(), seed=0, device=dev)),
                        ("random_xtts()", demo.model)):
        runs = []
        for i in range(2):
            _peak_reset(cuda)
            reset_counts()
            t0 = time.perf_counter()
            wav, sr = model.tts(XTTS_TEXT, ref24, 24000, seed=i)
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            runs.append(dict(seconds=secs, peak_gb=_peak_gb(cuda)))
            log(f"[engines] (c) XTTS {name} (dim {model.cfg.dim} x {model.cfg.n_layers}) tts "
                f"call {i + 1}, 256 codes: {secs:.3f} s, {len(wav) / sr:.2f} s of audio at {sr} "
                f"Hz, peak {runs[-1]['peak_gb']:.2f} GB; launches {launches} | {card}")
            expect(sr == 24000 and len(wav) == 256 * 256 and bool(np.isfinite(wav).all())
                   and not any(launches.values()),
                   f"xtts {name}: {wav.shape} at {sr}, launches {launches}")
        rec["xtts"][name] = runs

    # (d) XTTS-v2 at the published widths
    t0 = time.perf_counter()
    mods = build_xtts_v2(dev)
    ck = XttsCheckpointEngine(*mods, device=dev)
    sync(dev)
    log(f"[engines] (d) XTTS-v2: GPT-2 {len(ck.gpt.gpt.h)} x {ck.gpt.dim} x {ck.gpt.heads} "
        f"{n_params(ck.gpt):.1f} M, conditioning encoder {n_params(ck.cond_enc):.1f} M, "
        f"perceiver {n_params(ck.perceiver):.1f} M, speaker encoder "
        f"{n_params(ck.spk_enc):.1f} M, HiFi decoder {n_params(ck.decoder):.1f} M; built in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = []
    for i in range(2):
        _peak_reset(cuda)
        reset_counts()
        t0 = time.perf_counter()
        lat, dvec = ck.conditioning(ref24, 24000)
        sync(dev)
        cond_s = time.perf_counter() - t0
        wav, sr = ck.synthesize(XTTS_TEXT, cond=lat, d_vector=dvec, max_steps=XTTS_STEPS,
                                seed=i, timed=True)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        st = dict(ck.last_stats)
        run = dict(conditioning_s=cond_s, seconds=secs, prefill_s=st["prefill_s"],
                   decode_s=st["decode_s"], latents_s=st["latents_s"],
                   decoder_s=st["decoder_s"], steps_per_s=XTTS_STEPS / st["decode_s"],
                   peak_gb=_peak_gb(cuda), audio_s=len(wav) / sr)
        runs.append(run)
        log(f"[engines] (d) XTTS-v2 call {i + 1}: conditioning on {XTTS_REF_S:.0f} s "
            f"{cond_s:.3f} s; synthesize {XTTS_STEPS} steps: prefill {st['prefill_s']:.3f}, "
            f"decode {st['decode_s']:.3f} s = {run['steps_per_s']:.1f} steps/s, latents "
            f"{st['latents_s']:.3f}, HiFi decoder {st['decoder_s']:.3f}; {secs:.3f} s in all, "
            f"{run['audio_s']:.2f} s of audio at {sr} Hz; peak {run['peak_gb']:.2f} GB; "
            f"launches {launches} | {card}")
        expect(sr == 24000 and bool(np.isfinite(wav).all()) and not any(launches.values()),
               f"xtts-v2: {wav.shape} at {sr}, launches {launches}")
    rec["xtts_v2"] = runs
    if profile_dir and cuda:
        rec["xtts_v2_profile"] = profile_call(
            "XTTS-v2 warm synthesize",
            lambda: ck.synthesize(XTTS_TEXT, cond=lat, d_vector=dvec, max_steps=XTTS_STEPS,
                                  seed=1),
            {k: runs[-1][k] for k in ("prefill_s", "decode_s", "latents_s", "decoder_s")},
            dev, profile_dir, card)
    # the cached decode's logits against one full re-forward on the card
    gpt = ck.gpt
    tids = torch.as_tensor(np.asarray(ck.tokenize(XTTS_TEXT))[None], device=dev)
    codes, _lat, _n = xtts_gpt2_generate(gpt, tids, lat, XTTS_STEPS, seed=3, device=dev)
    tw = torch.cat([torch.full((1, 1), gpt.start_text, device=dev), tids,
                    torch.full((1, 1), gpt.stop_text, device=dev)], dim=1)
    mel = torch.cat([torch.full((1, 1), gpt.n_audio - 2, device=dev), codes], dim=1)
    with torch.inference_mode():
        full = gpt(tw, mel, lat)[1][0]
        offset = lat.shape[1] + tw.shape[1]
        caches = gpt.init_cache(1, offset + mel.shape[1], dev)
        steps = [gpt.prefill(tw, mel[:, :1], lat, caches)]
        for j in range(1, mel.shape[1]):
            pos = torch.tensor([j], device=dev)
            steps.append(gpt.step(mel[:, j], pos + offset, pos, caches))
        cached = torch.cat(steps)
    err = float((cached - full).abs().max() / full.abs().max())
    rec["xtts_v2_cached_vs_full"] = err
    log(f"[engines] (d) XTTS-v2 cached decode against one full re-forward over "
        f"{mel.shape[1]} mel positions, on the card: {err:.3e} of max|logit| (tol 1e-5)")
    expect(err <= 1e-5, f"xtts-v2: cached logits {err:.3e} from the full re-forward")

    # (h) card against CPU, XTTS-v2: latents and the HiFi waveform
    short = mel[:, :21]
    gpt_cpu = cpu_copy(gpt, XttsGPT2)
    with torch.inference_mode():
        lat_card = gpt(tw, short, lat, return_latents=True)[2]
        lat_cpu = gpt_cpu(tw.cpu(), short.cpu(), lat.cpu(), return_latents=True)[2]
    rec["xtts_v2_latents_card_vs_cpu"] = card_vs_cpu(
        "XTTS-v2 latents (GPT-2 30 x 1024, 21 mel positions)", lat_card.cpu(), lat_cpu,
        1e-5, tag="[engines] (h)")
    del gpt_cpu
    dec_cpu = cpu_copy(ck.decoder, XttsHifiganDecoder)
    with torch.inference_mode():
        wav_card = ck.decoder(lat_card[:, 1:], dvec)
        wav_cpu = dec_cpu(lat_cpu[:, 1:], dvec.cpu())
    rec["xtts_v2_hifi_card_vs_cpu"] = card_vs_cpu(
        "XTTS-v2 HiFi waveform (20 latent frames)", wav_card.cpu(), wav_cpu, 1e-5,
        tag="[engines] (h)")
    del dec_cpu, ck, mods, gpt, caches, full, cached
    torch.cuda.empty_cache()

    # (e) Zonos generate_embedded from the prefix bank
    tts = build_tts(dev, "mamba1")
    with torch.device(dev):
        bank = fast_init(ZonosPrefixConditioner(tts.model.cfg.dim, DEFAULT_ZONOS_CONDITIONERS),
                         5)
    phon = torch.as_tensor(tokenize_phonemes_np([phonemize_ipa(TTS_TEXT)]), device=dev)
    gz = torch.Generator(device=dev).manual_seed(6)
    cond = dict(espeak=phon, speaker=torch.randn((1, 1, 128), generator=gz, device=dev),
                emotion=torch.full((1, 1, 8), 0.1, device=dev),
                fmax=torch.full((1, 1, 1), 22050.0, device=dev),
                pitch_std=torch.full((1, 1, 1), 20.0, device=dev),
                speaking_rate=torch.full((1, 1, 1), 15.0, device=dev),
                language_id=torch.full((1, 1, 1), 24.0, device=dev))
    with torch.inference_mode():
        x2 = torch.cat([bank(cond), bank({"espeak": phon})])
    runs = []
    for i in range(2):
        st = {}
        _peak_reset(cuda)
        reset_counts()
        t0 = time.perf_counter()
        zc = generate_embedded(tts.model, x2, max_frames=ZONOS_EMB_FRAMES, seed=i, stats=st,
                               device=dev)
        with torch.inference_mode():
            za = tts.dac(torch.clamp(zc, 0, tts.model.cfg.codebook_size - 3))
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        runs.append(dict(seconds=secs, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                         steps_per_s=st["steps"] / st["decode_s"], peak_gb=_peak_gb(cuda)))
        log(f"[engines] (e) Zonos generate_embedded call {i + 1}: prefix {x2.shape[1]} "
            f"positions (phonemes {phon.shape[1]}), {ZONOS_EMB_FRAMES} frames: prefill "
            f"{st['prefill_s']:.3f} s, decode {st['steps']} steps {st['decode_s']:.3f} s = "
            f"{runs[-1]['steps_per_s']:.1f} steps/s, with the DAC {secs:.3f} s; peak "
            f"{runs[-1]['peak_gb']:.2f} GB; launches {launches} | {card}")
        expect(only(launches, "K2", 2) and A.flash_attention_fwd.sm90_launches == 0
               and bool(torch.isfinite(za).all()),
               f"zonos embedded: launches {launches}, finite {bool(torch.isfinite(za).all())}")
    rec["zonos_embedded"] = runs
    bank_cpu = cpu_copy(bank, lambda: ZonosPrefixConditioner(tts.model.cfg.dim,
                                                             DEFAULT_ZONOS_CONDITIONERS))
    with torch.inference_mode():
        rec["prefix_card_vs_cpu"] = card_vs_cpu(
            "Zonos prefix conditioner output", bank(cond).cpu(),
            bank_cpu({k: v.cpu() for k, v in cond.items()}), 1e-5, tag="[engines] (h)")
    del tts, bank, bank_cpu, x2, zc, za
    torch.cuda.empty_cache()

    # (f) the LM core at LMConfig(): one uncached forward, bf16
    t0 = time.perf_counter()
    with torch.device(dev):
        lm = fast_init(TransformerLM(LMConfig()), 0).eval()
    sync(dev)
    log(f"[engines] (f) TransformerLM LMConfig(): {n_params(lm):.1f} M parameters (bf16 "
        f"layers, fp32 head), built in {time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, lm.cfg.vocab_size, (1, LM_TOKENS), generator=g, device=dev)
    times = []
    for i in range(4):
        reset_counts()
        _peak_reset(cuda)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = lm(toks)
        sync(dev)
        times.append(time.perf_counter() - t0)
        launches, hop = counts(), A.flash_attention_fwd.sm90_launches
        expect(only(launches, "K2", lm.cfg.n_layers) and hop == lm.cfg.n_layers
               and bool(torch.isfinite(logits).all()),
               f"lm forward: launches {launches}, {hop} on the Hopper design")
        if i == 1:
            for k in path:
                path[k] += launches[k]
    rec["lm"] = dict(cold_s=times[0], warm_s=times[1:], peak_gb=_peak_gb(cuda))
    log(f"[engines] (f) uncached forward over {LM_TOKENS} tokens: cold {times[0]:.3f} s, warm "
        + " / ".join(f"{t * 1e3:.2f} ms" for t in times[1:]) + f"; logits "
        f"{tuple(logits.shape)} finite; peak {rec['lm']['peak_gb']:.2f} GB; launches "
        f"{launches} ({hop} on the Hopper route) | {card}")
    del lm, logits
    torch.cuda.empty_cache()

    # (g) the served routes, then main --demo-backends
    dia = build_dia(dev)
    eng = DiaTTSEngine(dia, dac, device=dev)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_engines_"))
    saved = dict(tts_api._BACKENDS)
    server, port = serve_background(create_app(str(work / "process"), device=dev))
    rec["served"] = {}
    try:
        tts_api.register_backend("dia", eng)
        tts_api.register_backend("coqui", demo)
        for model, text, want_sr, want_n, k2 in (
                ("dia", DIA_TEXT, 44100, frames * dac.cfg.hop, dia.cfg.n_layers_dec),
                ("coqui", XTTS_TEXT, 24000, None, 0)):
            reset_counts()
            t0 = time.perf_counter()
            status, resp = http("POST", f"http://127.0.0.1:{port}/api/v1/audio/speech",
                                {"model": model, "input": text})
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            expect(status == 200, f"speech {model}: HTTP {status} {resp.get('error')}")
            p = work / f"{model}.wav"
            p.write_bytes(base64.b64decode(resp["audio"]))
            a = read_wav(p)
            expect(a.sample_rate == want_sr and bool(np.isfinite(a.samples).all())
                   and (want_n is None or a.samples.shape == (1, want_n))
                   and only(launches, "K2", k2),
                   f"speech {model}: {a.samples.shape} at {a.sample_rate}, launches {launches}")
            rec["served"][model] = secs
            log(f"[engines] (g) POST /api/v1/audio/speech model {model!r}: HTTP {status} "
                f"{secs:.3f} s; WAV {a.sample_rate} Hz x {a.samples.shape[1]} samples "
                f"({a.samples.shape[1] / a.sample_rate:.2f} s); launches {launches} | {card}")
    finally:
        server.shutdown()
        server.server_close()
        tts_api._BACKENDS.clear()
        tts_api._BACKENDS.update(saved)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    out = open(work / "main.log", "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiolab_tpu_torch.main", "--port", str(mport),
         "--output-root", str(work / "main" / "process"), "--device", dev.type,
         "--demo-backends"],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{mport}"
        while True:
            try:
                status, models = http("GET", f"{url}/api/v1/audio/speech/models", timeout=30)
                break
            except (urllib.error.URLError, ConnectionError):
                expect(proc.poll() is None and time.perf_counter() - t0 < 180,
                       f"main --demo-backends: not serving (exit {proc.poll()}): "
                       f"{(work / 'main.log').read_text()[-2000:]}")
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        status, resp = http("POST", f"{url}/api/v1/audio/speech",
                            {"model": "coqui", "input": XTTS_TEXT})
        req_s = time.perf_counter() - t1
        expect(status == 200, f"main coqui: HTTP {status} {resp.get('error')}")
        p = work / "main_coqui.wav"
        p.write_bytes(base64.b64decode(resp["audio"]))
        a = read_wav(p)
        expect(a.sample_rate == 24000 and bool(np.isfinite(a.samples).all()),
               f"main coqui: {a.samples.shape} at {a.sample_rate}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log(f"[engines] (g) python -m audiolab_tpu_torch.main --demo-backends: serving after "
            f"{up_s:.3f} s with models {models}; POST speech 'coqui' {req_s:.3f} s, WAV "
            f"{a.sample_rate} Hz x {a.samples.shape[1]}; SIGTERM -> exit {rc}")
        expect(rc == 0, f"main --demo-backends: exit {rc}: "
                        f"{(work / 'main.log').read_text()[-2000:]}")
        rec["served"]["main_coqui"] = req_s
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        shutil.rmtree(work, ignore_errors=True)

    # (h) card against CPU, Dia's logits: prefill over BOS + 8 frames and 4 steps
    dia_cpu = cpu_copy(dia, lambda: DiaModel(DiaConfig()))
    gc = np.random.default_rng(8)
    pcodes = gc.integers(0, 1024, (1, 9, 9))
    steps_c = gc.integers(0, 1024, (4, 1, 9))
    seqs = {}
    for name, model, d in (("cpu", dia_cpu, cpu), ("card", dia, dev)):
        text = torch.as_tensor(ids, dtype=torch.long, device=d)
        mask = text != 0
        with torch.inference_mode():
            enc = model.encode_text(text, mask)
            logits, caches, cross = model.prefill(torch.as_tensor(pcodes, device=d), enc, mask)
            outs = [logits]
            for i, ct in enumerate(steps_c):
                outs.append(model.step(torch.as_tensor(ct, device=d),
                                       torch.tensor([9 + i], device=d), caches, cross, mask))
        seqs[name] = torch.stack(outs).cpu()
    rec["dia_card_vs_cpu"] = card_vs_cpu(
        "Dia logits (DiaConfig(), prefill over 9 positions and 4 steps)", seqs["card"],
        seqs["cpu"], 1e-5, tag="[engines] (h)")
    del dia, dia_cpu, eng, dac, demo
    torch.cuda.empty_cache()
    rec["launches"] = path
    log(f"[engines] the path's launches ((a)'s first call and (f)'s first warm forward): "
        f"{path}")
    expect(path["K2"] > 0, "engines: K2 was not launched on the path")
    return rec


# ---------------------------------------------------------- chatterbox

CB_TEXT = ("Welcome back to the studio, everyone. Today we are recording the vocals for our "
           "brand new song, and it is going to sound wonderful.")
CB_REF_S = 6.0                 # the cloning reference, at 24 kHz
CB_REF_SR = 24000
CB_TOKENS = 200                # max_tokens of the synthesize calls
CB_WARM = 2
CB_DIARIZE_S = 30.0


def cb_forward_len() -> int:
    """Rows of T3's teacher-forced forward over a cloned call's context (the
    speaker, the perceiver's 32 rows, the emotion, CB_TEXT's byte ids in
    their start and stop tokens, BOS) and CB_TOKENS speech tokens."""
    from audiolab_tpu_torch.pipelines.tts import chatterbox_punc_norm

    return 2 + 32 + len(chatterbox_punc_norm(CB_TEXT).encode()) + 2 + 1 + CB_TOKENS


def _two_speakers(seconds: float, sr: int) -> np.ndarray:
    """Alternating 5 s turns of two seeded voices (130 and 230 Hz harmonic
    tones with vibrato and different spectral tilts), 0.3 s gaps."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = np.zeros(n, np.float32)
    for i, s0 in enumerate(np.arange(0.0, seconds, 5.0)):
        f0, tilt = (130.0, 1.0) if i % 2 == 0 else (230.0, 2.0)
        sl = slice(int(s0 * sr), min(n, int((s0 + 4.7) * sr)))
        ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 4 * t[sl]))) / sr
        out[sl] = sum(0.3 / k ** tilt * np.sin(k * ph) for k in range(1, 8))
    return out + 0.003 * np.random.default_rng(9).standard_normal(n).astype(np.float32)


def build_chatterbox(dev):
    """Chatterbox's modules at their published widths, made on the device and
    filled by bench.py's rules (utils/fast_init.py) from seeds 0-4: (T3 at
    T3CkptConfig(), S3Token2Wav at FlowConfig() / HiFTConfig(), the voice
    encoder, CAMPPlus and the S3 tokenizer at their defaults)."""
    import torch

    from audiolab_tpu_torch.models.campplus import CAMPPlus, CAMPPlusConfig
    from audiolab_tpu_torch.models.chatterbox_s3gen import FlowConfig, HiFTConfig, S3Token2Wav
    from audiolab_tpu_torch.models.chatterbox_t3 import T3, T3CkptConfig, VoiceEncoder
    from audiolab_tpu_torch.models.s3tokenizer import S3TokenizerConfig, S3TokenizerV2
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return (fast_init(T3(T3CkptConfig()), 0),
                fast_init(S3Token2Wav(FlowConfig(), HiFTConfig()), 1),
                fast_init(VoiceEncoder(), 2),
                fast_init(CAMPPlus(CAMPPlusConfig()), 3),
                fast_init(S3TokenizerV2(S3TokenizerConfig()), 4))


def phase_chatterbox(dev, card: str, profile_dir: str | None = None) -> dict:
    """Chatterbox at its published widths on the card, weights by bench.py's
    rules (utils/fast_init.py): T3 at T3CkptConfig() (30 x 1024, 16 heads,
    ffn 4096), S3Gen at FlowConfig() / HiFTConfig(), the S3 tokenizer at
    S3TokenizerConfig() (12 x 1280), CAMPPlus and the voice encoder at their
    defaults.  (a) cloning: ``conditioning`` on a 6 s reference at 24 kHz
    and ``synthesize`` of CB_TEXT with max_tokens 200, prompted by the
    reference's 150 tokens; a cold call and CB_WARM warm ones, seconds by
    stage (voice encoder, CAMPPlus, S3 tokenizer, ref mel, T3 prefill and
    decode, flow, HiFT), steps/s, audio-s/s, peak memory, finite samples, no
    kernel launched; the captured decode against the eager loop (identical
    codes).  (b) T3's teacher-forced forward over (a)'s context and tokens:
    30 fp32 K2 (counts reset just before, read just after: the path's
    launches), the cached decode's logits within 1e-5 of max|logit| of it.
    (c) the builtin voice (no reference, no prompt) and random_chatterbox(),
    one synthesize each.  (d) NeuralDiarizer with the WeSpeaker ResNet34 back
    end on 30 s of two synthetic speakers.  (e) POST /api/v1/audio/speech
    with "chatterbox" (Dia registered beside it) and ``main --demo-backends``
    answering "chatterbox".  (f) card against CPU in fp32 (HiFT, CAMPPlus and
    the WeSpeaker ResNet with seeded default initialisers, see there)."""
    import base64
    import shutil
    import signal
    import socket
    import tempfile
    import urllib.error

    import torch

    from audiolab_tpu_torch.core.audio_io import read_wav
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels.kaldi import kaldi_fbank
    from audiolab_tpu_torch.models.campplus import CAMPPlus
    from audiolab_tpu_torch.models.chatterbox_s3gen import HiFTGenerator, S3Token2Wav
    from audiolab_tpu_torch.models.chatterbox_t3 import T3, t3_cached_logits, t3_generate
    from audiolab_tpu_torch.models.diarize import DiarizeConfig, NeuralDiarizer
    from audiolab_tpu_torch.models.lm import gumbel_draws
    from audiolab_tpu_torch.models.s3tokenizer import S3TokenizerV2, s3_log_mel
    from audiolab_tpu_torch.models.wespeaker import WeSpeakerResNet
    from audiolab_tpu_torch.pipelines.tts import (
        ChatterboxCheckpointEngine,
        chatterbox_punc_norm,
        random_chatterbox,
        register_default_backends,
    )
    from audiolab_tpu_torch.serve import tts_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    rec: dict = {}
    tag = "[chatterbox]"

    def n_params(m) -> float:
        return sum(p.numel() for p in m.parameters()) / 1e6

    def cpu_copy(module, make):
        c = make()
        c.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
        return c.eval()

    t0 = time.perf_counter()
    t3, s3gen, ve, cp, st = build_chatterbox(dev)
    eng = ChatterboxCheckpointEngine(t3, s3gen, ve=ve, campplus=cp, s3tok=st, device=dev)
    sync(dev)
    c = t3.cfg
    log(f"{tag} built in {time.perf_counter() - t0:.1f} s: T3 {c.n_layers} x {c.dim}, "
        f"{c.n_heads} heads, ffn {c.ffn_dim}, {n_params(t3):.1f} M fp32 parameters; flow "
        f"{n_params(s3gen.flow):.1f} M, HiFT {n_params(s3gen.mel2wav):.1f} M, S3 tokenizer "
        f"{n_params(st):.1f} M, CAMPPlus {n_params(cp):.2f} M, voice encoder "
        f"{n_params(ve):.2f} M")
    t_ref = np.arange(int(CB_REF_S * CB_REF_SR)) / CB_REF_SR
    ref = _tone(CB_REF_S, CB_REF_SR) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ref)).astype(
        np.float32)

    # (a) cloning, cold then warm
    runs = []
    for i in range(1 + CB_WARM):
        label = f"clone call {i + 1} ({'cold' if i == 0 else 'warm'})"
        _peak_reset(cuda)
        reset_counts()
        t0 = time.perf_counter()
        audio, sr = eng.synthesize(CB_TEXT, ref_wav=ref, ref_sr=CB_REF_SR,
                                   max_tokens=CB_TOKENS, seed=i, timed=True)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        st_ = dict(eng.last_stats)
        stages = {k: st_[k] for k in ("ve_s", "campplus_s", "s3tokenizer_s", "ref_mel_s",
                                      "prefill_s", "decode_s", "flow_s", "hift_s")}
        run = dict(seconds=secs, **stages, steps=st_["steps"], context=st_["context"],
                   tokens=st_["tokens"], steps_per_s=st_["steps"] / st_["decode_s"],
                   peak_gb=_peak_gb(cuda), audio_s=len(audio) / sr, launches=launches)
        runs.append(run)
        log(f"{tag} (a) {label}: {secs:.3f} s ("
            + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stages.items())
            + f"); context {run['context']} rows, {run['steps']} decode steps at "
            f"{run['steps_per_s']:.1f} steps/s ({1e3 / run['steps_per_s']:.2f} ms a step); "
            f"{run['tokens']} tokens to S3Gen; {run['audio_s']:.2f} s of audio at {sr} Hz, "
            f"{run['audio_s'] / secs:.2f} audio-s/s; peak {run['peak_gb']:.2f} GB; launches "
            f"{launches} | {card}")
        expect(sr == 24000 and len(audio) > 0 and bool(np.isfinite(audio).all()),
               f"{label}: {audio.shape} at {sr} Hz, expected finite 24 kHz audio")
        expect(all(v == 0 for v in launches.values()),
               f"{label}: launches {launches}; Chatterbox's generation runs no kernel")
    rec["clone"] = runs
    if profile_dir and cuda:
        rec["clone_profile"] = profile_call(
            "Chatterbox warm clone synthesize",
            lambda: eng.synthesize(CB_TEXT, ref_wav=ref, ref_sr=CB_REF_SR,
                                   max_tokens=CB_TOKENS, seed=1, timed=True),
            {k: runs[-1][k] for k in ("prefill_s", "decode_s", "flow_s", "hift_s")}, dev,
            profile_dir, card, tag=tag)
    # the captured decode against the eager loop under the same draws
    spk, rd = eng.conditioning(ref, CB_REF_SR)
    prompt = rd["ref_tokens"][:, :c.speech_cond_prompt_len]
    ids = np.asarray([[c.start_text_token] + list(eng.tokenize(chatterbox_punc_norm(CB_TEXT)))
                      + [c.stop_text_token]])
    draws = gumbel_draws(CB_TOKENS + 1, 1, c.speech_vocab, 7, dev)
    codes = {}
    for graph in ((True, False) if cuda else (False,)):
        t0 = time.perf_counter()
        codes[graph] = t3_generate(t3, ids, spk, prompt_tokens=prompt, max_new_tokens=CB_TOKENS,
                                   draws=draws, graph=graph, device=dev)
        sync(dev)
        log(f"{tag} (a) t3_generate graph={graph}: {codes[graph].shape[1]} tokens in "
            f"{time.perf_counter() - t0:.3f} s")
    if cuda:
        expect(np.array_equal(codes[True], codes[False]),
               "the captured T3 decode's codes differ from the eager loop's")
        log(f"{tag} (a) captured decode = eager decode: {codes[True].shape[1]} identical codes")
    gen = codes[False]

    # (b) the teacher-forced forward over (a)'s context and tokens: the path
    text = torch.as_tensor(ids, device=dev)
    speech = torch.as_tensor(np.concatenate([[[c.start_speech_token]], gen], axis=1),
                             device=dev)
    spk_t = torch.as_tensor(spk, device=dev)[None]
    prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    emo = torch.full((1,), 0.5, device=dev)
    with torch.inference_mode():
        t3(text, speech, spk_t, prompt_t, emo)          # warms the shapes
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        _lt, ls = t3(text, speech, spk_t, prompt_t, emo)
        sync(dev)
        fwd_s = time.perf_counter() - t0
        path = counts()
        hop = A.flash_attention_fwd.sm90_launches
        cached = t3_cached_logits(t3, text, speech[:, 1:], spk_t, prompt_t, emo)
    rows = speech.shape[1] + 2 + c.perceiver_tokens + text.shape[1]
    err = float((cached - ls).abs().max() / ls.abs().max())
    rec["forward"] = dict(rows=rows, seconds=fwd_s, launches=path, cached_vs_forward=err)
    log(f"{tag} (b) teacher-forced forward over {rows} rows ({text.shape[1]} text, "
        f"{c.perceiver_tokens} perceiver rows from {prompt.shape[1]} prompt tokens, "
        f"{speech.shape[1]} speech): {fwd_s * 1e3:.2f} ms; launches {path} ({hop} on the "
        f"16-bit Hopper design); cached decode against it: {err:.3e} of max|logit| "
        f"{float(ls.abs().max()):.4g} (tolerance 1e-5) | {card}")
    expect(only(path, "K2", c.n_layers) and hop == 0,
           f"T3 forward: launches {path}, expected {c.n_layers} fp32 K2")
    expect(err <= 1e-5, f"T3 cached decode {err:.3e} of max|logit| from the forward")
    del cached, ls, _lt

    # (c) the builtin voice and the demo engine
    demo = random_chatterbox(device=dev)
    for name, e in (("builtin voice (no reference, no prompt)", eng),
                    ("random_chatterbox()", demo)):
        reset_counts()
        t0 = time.perf_counter()
        audio, sr = e.synthesize(CB_TEXT, max_tokens=CB_TOKENS, seed=3, timed=True)
        sync(dev)
        secs = time.perf_counter() - t0
        st_ = e.last_stats
        log(f"{tag} (c) {name}: {secs:.3f} s (prefill {st_['prefill_s']:.3f}, decode "
            f"{st_['decode_s']:.3f}, flow {st_['flow_s']:.3f}, HiFT {st_['hift_s']:.3f}); "
            f"context {st_['context']}, {st_['steps']} steps; {len(audio) / sr:.2f} s of "
            f"audio; launches {counts()} | {card}")
        expect(sr == 24000 and len(audio) > 0 and bool(np.isfinite(audio).all()),
               f"{name}: {audio.shape} at {sr} Hz")
        rec[f"builtin_{name.split()[0]}"] = secs

    # (d) the diarizer's wespeaker back end
    ws = build_wespeaker(dev)
    diar = NeuralDiarizer(DiarizeConfig(), wespeaker=ws, device=dev)
    with torch.no_grad():
        # speaker 0 active in every chunk: one region a chunk for the back end
        diar.seg.fc2.bias.copy_(torch.tensor([4.0, -4.0, -4.0]))
    two = _two_speakers(CB_DIARIZE_S, 16000)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        turns = diar.diarize(two, 16000)
        sync(dev)
        times.append(time.perf_counter() - t0)
    regions = [(s, min(s + 10.0, CB_DIARIZE_S)) for s in np.arange(0.0, 25.0, 5.0)]
    t0 = time.perf_counter()
    embs = diar._wespeaker_embs(two, regions)
    sync(dev)
    emb_s = time.perf_counter() - t0
    rec["diarize"] = dict(cold_s=times[0], warm_s=times[1], embed_s=emb_s, turns=len(turns))
    log(f"{tag} (d) NeuralDiarizer, WeSpeaker ResNet34 ({n_params(ws):.2f} M) on "
        f"{CB_DIARIZE_S:.0f} s of two speakers: cold {times[0]:.3f} s, warm {times[1]:.3f} s, "
        f"{len(turns)} turns {turns}; {len(regions)} region embeddings "
        f"{tuple(embs.shape)} in {emb_s * 1e3:.1f} ms | {card}")
    expect(len(turns) >= 1 and embs.shape == (len(regions), 256)
           and bool(torch.isfinite(embs).all()), "diarizer: no turns or bad embeddings")

    # (e) the served routes, then main --demo-backends
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_chatterbox_"))
    saved = dict(tts_api._BACKENDS)
    server, port = serve_background(create_app(str(work / "process"), device=dev))
    try:
        register_default_backends(tts_api, dia=object(), chatterbox=eng)
        expect(tts_api._BACKENDS["chatterbox"] is eng, "chatterbox is not the Chatterbox engine")
        t0 = time.perf_counter()
        status, resp = http("POST", f"http://127.0.0.1:{port}/api/v1/audio/speech",
                            {"model": "chatterbox", "input": CB_TEXT})
        secs = time.perf_counter() - t0
        expect(status == 200, f"speech chatterbox: HTTP {status} {resp.get('error')}")
        p = work / "chatterbox.wav"
        p.write_bytes(base64.b64decode(resp["audio"]))
        a = read_wav(p)
        expect(a.sample_rate == 24000 and a.samples.shape[1] > 0
               and bool(np.isfinite(a.samples).all()),
               f"speech chatterbox: {a.samples.shape} at {a.sample_rate}")
        rec["served"] = secs
        log(f"{tag} (e) POST /api/v1/audio/speech model 'chatterbox': HTTP {status} "
            f"{secs:.3f} s from the Chatterbox engine (500 decode steps, the engine's "
            f"default); WAV {a.sample_rate} Hz x {a.samples.shape[1]} samples "
            f"({a.samples.shape[1] // 960} tokens) | {card}")
    finally:
        server.shutdown()
        server.server_close()
        tts_api._BACKENDS.clear()
        tts_api._BACKENDS.update(saved)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    out = open(work / "main.log", "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiolab_tpu_torch.main", "--port", str(mport),
         "--output-root", str(work / "main" / "process"), "--device", dev.type,
         "--demo-backends"],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{mport}"
        while True:
            try:
                status, models = http("GET", f"{url}/api/v1/audio/speech/models", timeout=30)
                break
            except (urllib.error.URLError, ConnectionError):
                expect(proc.poll() is None and time.perf_counter() - t0 < 180,
                       f"main --demo-backends: not serving (exit {proc.poll()}): "
                       f"{(work / 'main.log').read_text()[-2000:]}")
                time.sleep(0.25)
        expect("chatterbox" in models.get("loaded", []), f"main: models {models}")
        t1 = time.perf_counter()
        status, resp = http("POST", f"{url}/api/v1/audio/speech",
                            {"model": "chatterbox", "input": CB_TEXT})
        req_s = time.perf_counter() - t1
        expect(status == 200, f"main chatterbox: HTTP {status} {resp.get('error')}")
        p = work / "main_chatterbox.wav"
        p.write_bytes(base64.b64decode(resp["audio"]))
        a = read_wav(p)
        expect(a.sample_rate == 24000 and bool(np.isfinite(a.samples).all()),
               f"main chatterbox: {a.samples.shape} at {a.sample_rate}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log(f"{tag} (e) python -m audiolab_tpu_torch.main --demo-backends: models "
            f"{models['loaded']}; POST speech 'chatterbox' {req_s:.3f} s, WAV "
            f"{a.sample_rate} Hz x {a.samples.shape[1]}; SIGTERM -> exit {rc}")
        expect(rc == 0, f"main --demo-backends: exit {rc}: "
                        f"{(work / 'main.log').read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        shutil.rmtree(work, ignore_errors=True)

    # (f) card against CPU in fp32
    g = np.random.default_rng(11)
    w16 = ref[: 3 * 16000]                     # 3 s, as 16 kHz samples
    flow_tok = g.integers(0, 6561, (1, 60))
    xvec = g.standard_normal((1, 192)).astype(np.float32)
    pmel = g.standard_normal((1, 40, 80)).astype(np.float32)
    hdraws = [g.random((1, 1, 9)).astype(np.float32),
              g.standard_normal((1, 80 * 480, 9)).astype(np.float32)]
    fb = g.standard_normal((1, 300, 80)).astype(np.float32)
    t_text, t_speech = ids[:, :60], speech[:, :80].cpu().numpy()
    # HiFT, CAMPPlus and the WeSpeaker ResNet with torch's default
    # initialisers from a seed: under fast_init's N(0, 0.02) their outputs
    # are cancellations far below their inputs' level (HiFT's flat spectrum
    # iSTFTs to about 1 % of its magnitude, the x-vector to 6e-8), so the
    # comparison would read fp32 rounding of the inputs against a vanishing
    # scale (HiFT's read 1.2e-5 of its waveform's peak on an H100)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(12)
        hift = HiFTGenerator(s3gen.hift_cfg).eval()
        cp_f = CAMPPlus(cp.cfg).eval()
        ws_f = WeSpeakerResNet(ws.cfg).eval()
    res = {}
    for name, mods, d in (("card", (t3, s3gen, st), dev),
                          ("cpu", (cpu_copy(t3, lambda: T3(t3.cfg)),
                                   cpu_copy(s3gen, lambda: S3Token2Wav(s3gen.flow_cfg,
                                                                       s3gen.hift_cfg)),
                                   cpu_copy(st, lambda: S3TokenizerV2(st.cfg))), cpu)):
        m_t3, m_s3, m_st = mods
        m_s3.to(d)
        m_cp, m_ws = cp_f.to(d), ws_f.to(d)
        T = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=d)  # noqa: E731
        with torch.inference_mode():
            lg = m_t3(T(t_text), T(t_speech), T(spk[None]), T(prompt, torch.long),
                      torch.full((1,), 0.5, device=d))[1]
            mel = m_s3.flow(T(flow_tok), T(xvec), T(pmel), m_s3.rand_noise[:, :120])
            wav = hift.to(d)(mel[:, 40:], source_draws=[T(x) for x in hdraws])
            x16 = T(w16)[None]
            ids16 = m_st(s3_log_mel(x16))
            pre = m_st.project(s3_log_mel(x16))
            res[name] = dict(t3=lg, mel=mel, wav=wav, xvec=m_cp(T(fb)), ws=m_ws(T(fb)),
                             fbank=kaldi_fbank(x16), ids=ids16, pre=pre)
            res[name] = {k: v.cpu().numpy() for k, v in res[name].items()}
    errs = {}
    for key, label in (("t3", "T3 speech logits (60 text, 80 speech, 150 prompt)"),
                       ("mel", "flow mel under the fixed noise (60 tokens, 40 prompt frames)"),
                       ("wav", "HiFT (seeded default initialisers) waveform under the "
                               "same source draws (80 frames)"),
                       ("xvec", "CAMPPlus (seeded default initialisers) x-vector"),
                       ("ws", "WeSpeaker ResNet34 (seeded default initialisers) embedding"),
                       ("fbank", "kaldi fbank (3 s)")):
        errs[key] = card_vs_cpu(label, res["card"][key], res["cpu"][key], 1e-5,
                                tag=f"{tag} (f)")
    flips = res["card"]["ids"] != res["cpu"]["ids"]
    margin = np.abs(np.abs(res["cpu"]["pre"]) - 0.5)
    log(f"{tag} (f) S3 tokenizer ids (3 s, {flips.size} tokens): {int(flips.sum())} differ; "
        f"least distance of a pre-rounding value from a rounding boundary "
        f"{float(margin.min()):.3e}")
    expect(not flips.any(), f"S3 ids: {int(flips.sum())} differ between card and CPU")
    rec["card_vs_cpu"] = errs
    del t3, s3gen, ve, cp, st, ws, eng, demo, diar, hift, cp_f, ws_f
    torch.cuda.empty_cache()
    rec["launches"] = path
    log(f"{tag} the path's launches ((b)'s forward): {path}")
    expect(path["K2"] > 0, "chatterbox: K2 was not launched on the path")
    return rec


# ---------------------------------------------------------- processors

PROC_REF_S = 10.0            # the cloning reference: 10 s of a seeded tone
CREPE_METHODS = (("crepe", "full"), ("mangio-crepe", "full"), ("crepe-tiny", "tiny"),
                 ("mangio-crepe-tiny", "tiny"))
PROC_SERVED = ["Separate", "Clone", "Remaster", "Super Resolution", "Convert", "Compare"]


def build_openvoice(dev):
    """OpenVoiceCloner over a ToneColorConverter at ToneColorConfig()
    (OpenVoice's published converter widths), made on the device and filled
    by bench.py's rules from seed 0."""
    import torch

    from audiolab_tpu_torch.models.openvoice import ToneColorConfig, ToneColorConverter
    from audiolab_tpu_torch.pipelines.cloning import OpenVoiceCloner
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        model = fast_init(ToneColorConverter(ToneColorConfig()), 0)
    return OpenVoiceCloner(model, device=dev)


def card_vs_cpu(label: str, card_out, cpu_out, tol: float, scale: float | None = None,
                tag: str = "[processors] (g)", kind: str = "fp32") -> float:
    """max |card - cpu| over ``scale`` (default max |cpu|), printed with its
    tolerance after ``tag``; stops above it."""
    a = np.asarray(card_out, np.float64)
    b = np.asarray(cpu_out, np.float64)
    scale = float(np.abs(b).max()) if scale is None else scale
    err = float(np.abs(a - b).max()) / scale
    log(f"{tag} {label}, card against CPU in {kind}: {err:.3e} of the scale {scale:.4g} "
        f"(tolerance {tol:g}) | shape {b.shape}")
    expect(a.shape == b.shape and bool(np.isfinite(a).all()) and err <= tol,
           f"{tag} {label} card {err:.3e} from the CPU's (tolerance {tol:g})")
    return err


def phase_processors(dev, sep, vc, audio, card: str) -> dict:
    """The rest of the processor registry on the card, on the chain's 60 s
    track: (a) Remaster (against the source) -> Convert -> Compare of the
    separated instrumental, Super Resolution 44.1 -> 48 kHz with
    tgt_ensemble off and on; (b) Clone by OpenVoice on the vocals at
    22.05 kHz with a 10 s reference; (c) Clone by TTS (the facade's ZonosTTS,
    three sentences: 2 fp32 K2); (d) Clone by OpenVoice with
    diarize_speakers over the Zonos SpeakerEncoder; (e) VoiceConverter.convert
    with each crepe method (full and tiny nets: 12 K2 each); (f) one served
    chain Separate -> Clone (OpenVoice) -> Remaster -> Super Resolution ->
    Convert -> Compare (48 K1, no K2); (g) card against CPU in fp32.  Each
    step of (a)-(e) runs cold then warm, counts reset just before and read
    just after, with its seconds and peak memory."""
    import base64
    import dataclasses
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
    from audiolab_tpu_torch.core.chunking import plan_chunks
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels.resample import resample_poly_np
    from audiolab_tpu_torch.models.crepe import Crepe, CrepePredictor, viterbi_bins
    from audiolab_tpu_torch.models.diarize import NeuralDiarizer
    from audiolab_tpu_torch.pipelines.chain import run_chain
    from audiolab_tpu_torch.pipelines.cloning import (
        CloningFacade,
        OpenVoiceCloneConfig,
        OpenVoiceCloner,
    )
    from audiolab_tpu_torch.pipelines.processors.clone import Clone
    from audiolab_tpu_torch.pipelines.processors.remaster import match_spectrum
    from audiolab_tpu_torch.pipelines.processors.separate import Separate
    from audiolab_tpu_torch.pipelines.rvc import VoiceConverter
    from audiolab_tpu_torch.pipelines.super_res import sbr_enhance
    from audiolab_tpu_torch.pipelines.tts import parse_emotion_chunks
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cpu = torch.device("cpu")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_processors_"))
    rec: dict = {"steps": {}}
    n = audio.shape[-1]

    def step(name: str, fn, check, runs: int = 2):
        """``fn`` cold then warm: seconds, peak memory and launches of each
        run; ``check(result, launches, label)`` after each."""
        times, out = [], None
        for i in range(runs):
            label = f"{name} ({'cold' if i == 0 else 'warm'})"
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            check(out, launches, label)
            times.append(dict(seconds=secs, peak_gb=peak, launches=launches))
            log(f"[processors] {label}: {secs:.3f} s, peak {peak:.2f} GB, launches "
                f"{ {k: v for k, v in launches.items() if v} } | {card}")
        rec["steps"][name] = times
        return out

    def stage_marks(titles, files, settings, root):
        marks = []

        def mark(_i, msg, _n):
            if msg.startswith("Running "):
                marks.append((msg[len("Running "):], time.perf_counter()))

        projs = run_chain(titles, files, settings, output_root=str(root), device=dev,
                          callback=mark)
        sync(dev)
        end = time.perf_counter()
        stages = {name: (marks[i + 1][1] if i + 1 < len(marks) else end) - t
                  for i, (name, t) in enumerate(marks)}
        return projs[0], stages

    def no_kernels(launches, label):
        expect(all(v == 0 for v in launches.values()),
               f"{label}: launches {launches}, expected none")

    try:
        # inputs: the track, its stems (one separation, as in phase separator)
        song = work / "track.wav"
        write_wav(song, audio.float().cpu().numpy(), SEP_SR)
        stems = sep.separate(audio, as_numpy=False)
        vocals, inst = stems["vocals"], stems["instrumental"]
        inst_wav = work / "track (Instrumental).wav"
        write_wav(inst_wav, inst.float().cpu().numpy(), SEP_SR)
        v22 = resample_poly_np(vocals.float().cpu().numpy(), SEP_SR, 22050)
        vocals_wav = work / "track (Vocals).wav"
        write_wav(vocals_wav, v22, 22050)
        ref_wav = work / "reference.wav"
        write_wav(ref_wav, harmonic_tone(22050, int(PROC_REF_S * 22050), 180.0, 7), 22050)
        n22 = v22.shape[-1]

        # (a) Remaster -> Convert -> Compare, Super Resolution
        def remaster_chain(rep=[0]):
            rep[0] += 1
            proj, stages = stage_marks(
                ["Remaster", "Convert", "Compare"], [str(inst_wav)],
                {"Remaster": {"reference_file": str(song)}, "Convert": {"format": "wav"}},
                work / f"remaster{rep[0]}")
            return proj, stages

        def check_remaster(out, launches, label):
            proj, stages = out
            no_kernels(launches, label)
            files = [Path(p).name for p in proj.last_outputs]
            expect(files == ["comparison.json", "comparison.png"], f"{label}: {files}")
            metrics = json.loads(Path(proj.last_outputs[0]).read_text())
            mastered = read_wav(Path(proj.project_dir) / "converted"
                                / "track (Instrumental)_remastered.wav")
            peak = float(np.abs(mastered.samples).max())
            expect(mastered.samples.shape == (2, n) and mastered.sample_rate == SEP_SR
                   and bool(np.isfinite(mastered.samples).all()) and 0 < peak <= 0.986,
                   f"{label}: mastered {mastered.samples.shape} peak {peak}")
            expect(all(np.isfinite(metrics[k]) for k in ("rms_diff", "spec_l1", "spec_max")),
                   f"{label}: metrics {metrics}")
            log(f"[processors] (a) {label}: stages "
                + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
                + f"; mastered peak {peak:.4f}; Compare {metrics}")

        step("remaster_convert_compare", remaster_chain, check_remaster)
        sr_chunks = plan_chunks(-(-n * 48000 // SEP_SR), int(10.24 * 48000),
                                int(0.04 * 10.24 * 48000)).count
        expect(sr_chunks == 7, f"super resolution: {sr_chunks} chunks, expected 7")
        for ensemble in (False, True):
            def super_res(ensemble=ensemble, rep=[0]):
                rep[0] += 1
                return stage_marks(["Super Resolution"], [str(song)],
                                   {"Super Resolution": {"tgt_ensemble": ensemble}},
                                   work / f"sr{int(ensemble)}_{rep[0]}")

            def check_sr(out, launches, label, ensemble=ensemble):
                proj, _stages = out
                no_kernels(launches, label)
                y = read_wav(proj.last_outputs[0])
                want = (2, -(-n * 48000 // SEP_SR))
                expect(y.sample_rate == 48000 and y.samples.shape == want
                       and bool(np.isfinite(y.samples).all()),
                       f"{label}: {y.samples.shape} at {y.sample_rate}, expected {want} at 48000")
                log(f"[processors] (a) {label}: {sr_chunks} chunks of 10.24 s, stereo, "
                    f"tgt_ensemble {ensemble}; peak {np.abs(y.samples).max():.4f}")

            step(f"super_resolution_ensemble_{ensemble}", super_res, check_sr)

        # (b) Clone by OpenVoice
        t0 = time.perf_counter()
        cloner = build_openvoice(dev)
        sync(dev)
        n_ov = sum(p.numel() for p in cloner.model.parameters())
        log(f"[processors] OpenVoice ToneColorConverter: {n_ov / 1e6:.1f} M parameters, built "
            f"in {time.perf_counter() - t0:.1f} s; {cloner.cfg}")
        clone_ov = {"Clone": {"clone_method": "OpenVoice", "source_speaker": str(ref_wav)}}

        def clone(settings, tag, rep=[0]):
            rep[0] += 1
            return stage_marks(["Clone"], [str(vocals_wav)], settings, work / f"{tag}{rep[0]}")

        def check_clone(sr_want, n_want, k2=0):
            def check(out, launches, label):
                proj, _ = out
                expect(launches["K2"] == k2 and all(v == 0 for k, v in launches.items()
                                                    if k != "K2"),
                       f"{label}: launches {launches}, expected K2 {k2} and no other")
                expect(list(proj.file_dict) == ["cloned"], f"{label}: stages {proj.file_dict}")
                y = read_wav(proj.last_outputs[0])
                expect(y.sample_rate == sr_want and bool(np.isfinite(y.samples).all())
                       and (n_want is None or y.samples.shape[-1] == n_want),
                       f"{label}: {y.samples.shape} at {y.sample_rate}")
                log(f"[processors] {label}: {y.samples.shape[-1] / y.sample_rate:.2f} s at "
                    f"{y.sample_rate} Hz, peak {np.abs(y.samples).max():.4f}")
            return check

        Clone.configure(None, CloningFacade(openvoice=cloner))
        chunks = plan_chunks(n22, int(cloner.ccfg.chunk_seconds * 22050) // 256 * 256,
                             int(cloner.ccfg.overlap_seconds * 22050) // 256 * 256).count
        log(f"[processors] (b) Clone by OpenVoice: {n22 / 22050:.1f} s at 22.05 kHz in "
            f"{chunks} chunks of {cloner.ccfg.chunk_seconds} s, a {PROC_REF_S} s reference")
        step("clone_openvoice", lambda: clone(clone_ov, "ov"), check_clone(22050, n22))

        # (c) Clone by TTS, (d) diarize_speakers
        t0 = time.perf_counter()
        tts = build_tts(dev, "mamba1")
        sync(dev)
        log(f"[processors] ZonosTTS built in {time.perf_counter() - t0:.1f} s")
        chunks_tts = parse_emotion_chunks(TTS_TEXT)
        _ids, _em, frames = tts.encode_text(chunks_tts)
        sil = int(tts.cfg.silence_ms / 1000.0 * tts.cfg.sr)
        want_tts = len(chunks_tts) * frames * tts.dac.cfg.hop + (len(chunks_tts) - 1) * sil
        facade = CloningFacade(openvoice=cloner, tts=tts, spk_encoder=tts.spk_enc)
        Clone.configure(None, facade)
        step("clone_tts", lambda: clone(dict(Clone={"clone_method": "TTS",
                                                    "source_speaker": str(ref_wav),
                                                    "custom_text": TTS_TEXT}), "tts"),
             check_clone(44100, want_tts, k2=2))
        picked, turns = facade.choose_speaker(read_wav(vocals_wav).samples.mean(axis=0), 22050,
                                              index=0)
        log(f"[processors] (d) diarize over the Zonos SpeakerEncoder: {len(turns)} turns, "
            f"{len({s for *_, s in turns})} speakers, speaker 0 holds "
            f"{len(picked) / 22050:.2f} s")
        step("clone_openvoice_diarized",
             lambda: clone(dict(Clone=dict(clone_ov["Clone"], diarize_speakers=True)), "dia"),
             check_clone(22050, len(picked)))

        # (e) the crepe methods
        preds = {}
        for name in ("full", "tiny"):
            with torch.device(dev):
                net = fast_init(Crepe(name), 3)
            preds[name] = CrepePredictor(net, device=dev)
        x16 = to_rvc_input(vocals)
        k2 = HUBERT_LAYERS * rvc_groups(vc, x16.shape[-1])
        plan = rvc_plan(vc, x16.shape[-1])
        probs = torch.rand((min(plan.count, vc.cfg.device_batch), 1 + plan.chunk // 160, 360),
                           generator=torch.Generator(device=dev).manual_seed(4), device=dev)
        for rep in ("cold", "warm"):
            t0 = time.perf_counter()
            viterbi_bins(probs)
            sync(dev)
            log(f"[processors] (e) viterbi_bins on {tuple(probs.shape)} ({rep}): "
                f"{time.perf_counter() - t0:.3f} s (the forward loop on the device, the "
                f"backtrack on the host) | {card}")
        for method, size in CREPE_METHODS:
            cvc = VoiceConverter(vc.synth, vc.hubert, crepe=preds[size],
                                 index_features=vc.index_features,
                                 cfg=dataclasses.replace(vc.cfg, f0_method=method), device=dev)

            def check_convert(out, launches, label, cvc=cvc):
                expect(launches["K2"] == k2 and all(v == 0 for k, v in launches.items()
                                                    if k != "K2"),
                       f"{label}: launches {launches}, expected K2 {k2}")
                expect(out.shape[-1] == x16.shape[-1] * 3 and bool(torch.isfinite(out).all()),
                       f"{label}: {tuple(out.shape)}")
                expect(cvc._f0_on_host(), f"{label}: the crepe method fell back to YIN")

            step(f"convert_{method}", lambda cvc=cvc: cvc.convert(x16, sid=0, seed=0,
                                                                   as_numpy=False),
                 check_convert)

        # (f) the served chain
        Separate.configure(sep)
        Clone.configure(None, CloningFacade(openvoice=cloner))
        served = work / "served"
        server, port = serve_background(create_app(str(served), device=dev))
        try:
            body = {"files": [{"filename": "track.wav",
                               "content": base64.b64encode(song.read_bytes()).decode()}],
                    "processors": PROC_SERVED, "settings": clone_ov}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            status, resp = http("POST", f"http://127.0.0.1:{port}/api/v1/process/chain", body)
            sync(dev)
            secs = time.perf_counter() - t0
            launches = counts()
            expect(status == 200, f"processors request: HTTP {status} {resp.get('error')}")
            names = [f["filename"] for f in resp["files"]]
            expect(names == ["comparison.json", "comparison.png"], f"processors request: {names}")
            project = next(p for p in served.iterdir() if p.is_dir())
            stages = sorted(d.name for d in project.iterdir() if d.is_dir())
            expect({"stems", "cloned", "remastered", "super_res", "converted", "compare"}
                   <= set(stages), f"processors request: stages {stages}")
            check_launches(dev, launches, A.attention_nk1.sm90_launches, 48, 0,
                           "processors request")
            metrics = json.loads(base64.b64decode(resp["files"][0]["content"]))
            peak = torch.cuda.max_memory_allocated() / 1e9
            rec.update(request_s=secs, served_launches=launches, request_peak_gb=peak)
            log(f"[processors] (f) POST /api/v1/process/chain {PROC_SERVED} on "
                f"{n / SEP_SR:.1f} s: HTTP {status} {secs:.3f} s, peak {peak:.2f} GB; stages "
                f"{stages}; Compare {metrics}; launches {launches} | {card}")
        finally:
            server.shutdown()
            server.server_close()

        # (g) card against CPU, fp32
        ov_cpu = OpenVoiceCloner(type(cloner.model)(cloner.cfg), OpenVoiceCloneConfig(1.0, 0.2),
                                 device=cpu)
        ov_cpu.model.load_state_dict({k: v.cpu() for k, v in cloner.model.state_dict().items()})
        ov_card = OpenVoiceCloner(cloner.model, OpenVoiceCloneConfig(1.0, 0.2), device=dev)
        src, ref = v22.mean(axis=0)[: 2 * 22050], harmonic_tone(22050, 3 * 22050, 180.0, 7)
        rec["openvoice_card_vs_cpu"] = card_vs_cpu(
            "OpenVoice waveform (2 s, 1 s chunks)", ov_card.convert(src, 22050, ref, 22050)[0],
            ov_cpu.convert(src, 22050, ref, 22050)[0], 1e-4)
        del ov_cpu
        frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (16, 1024)).astype(np.float32))
        for name, pred in preds.items():
            net = pred.net
            net_cpu = Crepe(net.model).eval()
            net_cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
            with torch.no_grad():
                rec[f"crepe_{name}_card_vs_cpu"] = card_vs_cpu(
                    f"Crepe({name!r}) salience (16 frames)", net(frames.to(dev)).cpu(),
                    net_cpu(frames), 1e-5, scale=1.0)
        del preds
        t = torch.from_numpy(inst.float().cpu().numpy()[:1, : 10 * SEP_SR])
        r = torch.from_numpy(audio.float().cpu().numpy()[:1, 10 * SEP_SR: 18 * SEP_SR])
        rec["match_spectrum_card_vs_cpu"] = card_vs_cpu(
            "match_spectrum (10 s against 8 s)", match_spectrum(t.to(dev), r.to(dev)).cpu(),
            match_spectrum(t, r), 1e-4)
        chunk = torch.from_numpy(audio.float().cpu().numpy()[None, :, : int(10.24 * 48000)])
        rec["sbr_card_vs_cpu"] = card_vs_cpu(
            "sbr_enhance (one 10.24 s stereo chunk)", sbr_enhance(chunk.to(dev)).cpu(),
            sbr_enhance(chunk), 1e-4)
        dz = NeuralDiarizer(device=dev)
        dz_cpu = NeuralDiarizer(device=cpu)
        dz_cpu.seg.load_state_dict({k: v.cpu() for k, v in dz.seg.state_dict().items()})
        batch = resample_poly_np(v22.mean(axis=0)[: 20 * 22050], 22050, 16000)
        batch = batch[: 2 * (len(batch) // 2)].reshape(2, -1)
        rec["diarizer_card_vs_cpu"] = card_vs_cpu(
            "NeuralDiarizer activities (2 chunks)", dz.activities(batch)[0],
            dz_cpu.activities(batch)[0], 1e-5, scale=1.0)
    finally:
        Separate.configure(None)
        Clone.configure(None)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------- transcribe

# openai-whisper's ModelDimensions for large-v3 (1.55 B parameters)
def build_whisper(dev, seed: int = 0, **cut):
    """Whisper at large-v3's dimensions on ``dev`` (``cut`` overrides its
    depths), weights by bench.py's rules."""
    import torch

    from audiolab_tpu_torch.models.whisper import WhisperConfig, WhisperModel
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(WhisperModel(WhisperConfig(**dict(WHISPER_LARGE_V3, **cut))), seed).eval()


def build_w2v(dev, seed: int = 2):
    """The CTC aligner's net at wav2vec2-base-960h's widths on ``dev``."""
    import torch

    from audiolab_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(Wav2Vec2CTC(Wav2Vec2Config()), seed).eval()


def build_pyannet(dev, seed: int = 3):
    """PyanNet at segmentation-3.0's widths (``PyanNetConfig()``) on ``dev``."""
    import torch

    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(PyanNet(PyanNetConfig()), seed).eval()


def build_rtla(dev, seed: int = 4):
    """RTLA's CRNN at ``RtlaCRNNConfig()`` on ``dev``."""
    import torch

    from audiolab_tpu_torch.models.rtla import RtlaCRNN, RtlaCRNNConfig
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(RtlaCRNN(RtlaCRNNConfig()), seed).eval()


def build_wespeaker(dev, seed: int = 5):
    """The WeSpeaker ResNet34 (``WeSpeakerConfig()``) on ``dev``."""
    import torch

    from audiolab_tpu_torch.models.wespeaker import WeSpeakerConfig, WeSpeakerResNet
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        return fast_init(WeSpeakerResNet(WeSpeakerConfig()), seed)


def build_audiosr(dev, seed: int = 70):
    """AudioSR's VAE, UNet and vocoder at the published widths on ``dev``,
    seeded ``seed``, ``seed + 1``, ``seed + 2``."""
    import torch

    from audiolab_tpu_torch.models.audiosr_unet import AudioSRUNet
    from audiolab_tpu_torch.models.audiosr_vae import AudioSRVAE
    from audiolab_tpu_torch.models.audiosr_vocoder import AudioSRVocoder
    from audiolab_tpu_torch.utils.fast_init import fast_init

    with torch.device(dev):
        mods = AudioSRVAE(), AudioSRUNet(), AudioSRVocoder()
    for i, m in enumerate(mods):
        fast_init(m.eval(), seed + i)
    return mods


WHISPER_LARGE_V3 = dict(n_mels=128, n_audio_ctx=1500, dim=1280, n_heads=20, n_audio_layers=32,
                        n_text_layers=32, vocab_size=51866, n_text_ctx=448, sot=50258,
                        eot=50257, no_timestamps=50364, timestamp_base=50365)
TR_AUDIO_S = 60.0             # two 30 s windows
TR_TOKENS = 64                # max_tokens of the decode
TR_WARM = 2
TR_SPANS = (5.0, 10.0, 20.0, 30.0)   # the aligner's segments, 12 words each
TR_WORDS = "welcome back to the studio everyone today we record our new song".split()
ALIGN_S = 30.0


def hubert_frames(seconds: float, sr: int = 16000) -> int:
    """20 ms frames the HuBERT / wav2vec2 conv stack gives ``seconds`` of audio."""
    n = int(seconds * sr)
    for k, s in [(10, 5)] + [(3, 2)] * 4 + [(2, 2)] * 2:
        n = (n - k) // s + 1
    return n


def gliding_notes(durations, seed: int, sr: int = 16000) -> np.ndarray:
    """Harmonic notes, each gliding up 4 semitones over its duration, a
    seeded pitch each (the alignment phase's master and take)."""
    rng = np.random.default_rng(seed)
    pitches = np.random.default_rng(100).integers(55, 80, len(durations))
    out = []
    for m, d in zip(pitches, durations):
        t = np.arange(int(d * sr)) / sr
        f = 440.0 * 2 ** ((m - 69 + 4 * t / d) / 12)
        ph = 2 * np.pi * np.cumsum(f) / sr
        out.append(sum(0.3 / k * np.sin(k * ph) for k in (1, 2, 3)))
    x = np.concatenate(out)
    return (x + 0.003 * rng.standard_normal(len(x))).astype(np.float32)


def note_words(durations, per_sentence: int = 6) -> list[dict]:
    words, t = [], 0.0
    for i, d in enumerate(durations):
        end = "." if (i + 1) % per_sentence == 0 else ""
        words.append({"word": f"note{i}{end}", "start": round(t, 3), "end": round(t + d, 3)})
        t += d
    return words


def phase_transcribe(dev, card: str) -> dict:
    """Transcription and multi-take alignment at published widths on the
    card, weights by bench.py's rules (utils/fast_init.py).  (a) Whisper at
    large-v3's dimensions (128 mels, 32 + 32 layers of 1280, 20 heads, 51,866
    tokens) on 60 s at 16 kHz (two windows): the log-mel, the encoder's
    seconds cold and warm, transcribe_window with max_tokens 64 (one step
    captured and replayed) cold and TR_WARM warm, steps/s, the eager loop's
    tokens identical; the uncached forward over the decoded tokens (32 fp32
    K2, one per decoder layer: counts reset just before, read just after)
    against the cached decode's logits (1e-5 of max|logit|); card against
    CPU at a cut depth (2 + 2 layers at full width): the mel (as power) and
    the logits within 1e-5 of the scale.  (b) CTCWordAligner at wav2vec2-base-960h's
    widths (HubertConfig(), vocab 32) on spans of 5, 10, 20 and 30 s with 12
    words each, cold (a new length) and warm: 12 fp32 K2 per span, log-probs
    card against CPU (1e-5 of the scale), the CTC spans identical.  (c)
    PyanNet at PyanNetConfig() through pyannet_vad on the 60 s: seconds and
    regions; log-probs card against CPU (1e-5 of the scale) and the speech
    decisions the same wherever the two are further from a tie than ten
    times their difference; NeuralDiarizer with the PyanNet back end on 30 s
    of two speakers.  (d) align_take of a 30 s take onto a 30 s master
    (gliding notes, one word each), with chroma alone and with RtlaCRNN at
    RtlaCRNNConfig(); the phoneme stream card against CPU.  (e) POST
    /api/v1/audio/transcriptions (Whisper with the aligner and the VAD) on
    the 60 s, POST /api/v1/align with the two takes, and ``main
    --demo-backends`` answering "whisper".  Returns the path's launches:
    (a)'s uncached forward and (b)'s first call of each span."""
    import base64
    import shutil
    import signal
    import socket
    import tempfile
    import urllib.error

    import torch

    from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
    from audiolab_tpu_torch.models.diarize import NeuralDiarizer
    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig, powerset_to_multilabel
    from audiolab_tpu_torch.models.rtla import RtlaCRNN, RtlaCRNNConfig, phoneme_features
    from audiolab_tpu_torch.models.wav2vec2 import CTCWordAligner, Wav2Vec2Config, Wav2Vec2CTC
    from audiolab_tpu_torch.models.whisper import (
        WhisperConfig,
        WhisperModel,
        cached_logits,
        log_mel_30s,
        transcribe_window,
    )
    from audiolab_tpu_torch.pipelines.align import align_take
    from audiolab_tpu_torch.pipelines.forced_align import ctc_forced_align
    from audiolab_tpu_torch.pipelines.transcribe import Transcriber, pyannet_vad
    from audiolab_tpu_torch.serve import align_api, transcribe_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)
    tag = "[transcribe]"

    def n_params(m) -> float:
        return sum(p.numel() for p in m.parameters()) / 1e6

    def cpu_copy(module, make):
        c = make()
        c.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
        return c.eval()

    def k2_only(launches, n):
        # the CPU's plain versions count no launch
        return only(launches, "K2", n) if cuda else not any(launches.values())

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    x60 = _two_speakers(TR_AUDIO_S, 16000)

    # (a) Whisper at large-v3's dimensions
    cfg = WhisperConfig(**WHISPER_LARGE_V3)
    t0 = time.perf_counter()
    whisper = build_whisper(dev)
    sync(dev)
    log(f"{tag} (a) Whisper large-v3 dimensions: {n_params(whisper):.1f} M parameters fp32, "
        f"built in {time.perf_counter() - t0:.1f} s")
    mel, mel_s = timed(lambda: log_mel_30s(x60, cfg, dev))
    expect(tuple(mel.shape) == (2, 3000, cfg.n_mels) and bool(torch.isfinite(mel).all()),
           f"log-mel {tuple(mel.shape)}")
    enc_s = []
    for _ in range(1 + TR_WARM):
        with torch.inference_mode():
            xa, secs = timed(lambda: whisper.encode(mel))
        enc_s.append(secs)
    expect(tuple(xa.shape) == (2, cfg.n_audio_ctx, cfg.dim) and bool(torch.isfinite(xa).all()),
           f"encoder output {tuple(xa.shape)}")
    del xa
    log(f"{tag} (a) log-mel of 60 s {mel_s:.3f} s; encoder (2 windows) cold {enc_s[0]:.3f} s, "
        f"warm {', '.join(f'{s:.4f}' for s in enc_s[1:])} s | {card}")
    runs = []
    for _ in range(1 + TR_WARM):
        stats: dict = {}
        toks, secs = timed(lambda: transcribe_window(whisper, mel, TR_TOKENS, device=dev,
                                                     stats=stats))
        runs.append(dict(stats, total=secs))
    stats_e: dict = {}
    toks_e, eager_s = timed(lambda: transcribe_window(whisper, mel, TR_TOKENS, device=dev,
                                                      graph=False, stats=stats_e))
    expect(torch.equal(toks, toks_e), "Whisper: the captured decode's tokens differ from "
                                      "the eager loop's")
    rec["whisper"] = dict(mel_s=mel_s, encoder_s=enc_s, runs=runs, eager=stats_e)
    for i, r in enumerate(runs):
        log(f"{tag} (a) transcribe_window {'cold' if i == 0 else 'warm'}: {r['total']:.3f} s "
            f"(encode {r['encode']:.3f}, decode {r['decode']:.3f}: {TR_TOKENS / r['decode']:.1f} "
            f"steps/s, {1e3 * r['decode'] / TR_TOKENS:.2f} ms a step) | {card}")
    log(f"{tag} (a) the eager loop: decode {stats_e['decode']:.3f} s "
        f"({TR_TOKENS / stats_e['decode']:.1f} steps/s); tokens identical to the graph's "
        f"({len(torch.unique(toks))} distinct, {int((toks == cfg.eot).sum())} EOT)")
    tokens_in = torch.cat([torch.full((2, 1), cfg.sot, device=dev), toks[:, :-1]], dim=1)
    reset_counts()
    with torch.inference_mode():
        logits, fwd_s = timed(lambda: whisper(mel, tokens_in))
    launches = counts()
    expect(k2_only(launches, cfg.n_text_layers),
           f"Whisper's uncached forward: launches {launches}, expected "
           f"{cfg.n_text_layers} K2")
    for k in path:
        path[k] += launches[k]
    cached = cached_logits(whisper, mel, tokens_in)
    err = float((cached - logits).abs().max() / logits.abs().max())
    expect(err <= 1e-5, f"Whisper cached decode {err:.3e} of max|logit| from the uncached")
    agree = float((logits.argmax(-1) == toks).float().mean())
    log(f"{tag} (a) uncached forward over SOT + 63 decoded tokens: {fwd_s:.3f} s, launches "
        f"{launches}; the cached decode's logits {err:.3e} of max|logit| from it; its argmax "
        f"equals the next decoded token at {100 * agree:.1f} % of positions")
    rec["whisper_cached_vs_uncached"] = err
    del logits, cached
    cut_kw = dict(WHISPER_LARGE_V3, n_audio_layers=2, n_text_layers=2)
    cut = build_whisper(dev, 1, n_audio_layers=2, n_text_layers=2)
    cut_cpu = cpu_copy(cut, lambda: WhisperModel(WhisperConfig(**cut_kw)))
    mel_cpu = log_mel_30s(x60, cfg, cpu)
    # as power: the log magnifies cuFFT's rounding in bins 60-80 dB under the
    # peak (the front end keeps 80 dB), 4.4e-05 of the log-mel's scale
    card_vs_cpu("Whisper mel power (60 s, 2 windows; the log-mel read back as power)",
                10 ** (4 * mel.cpu().double() - 4), 10 ** (4 * mel_cpu.double() - 4), 1e-5,
                tag=f"{tag} (a)")
    with torch.inference_mode():
        lc = cut(mel, tokens_in).cpu()
        lh = cut_cpu(mel.cpu(), tokens_in.cpu())
    rec["whisper_card_vs_cpu"] = card_vs_cpu(
        "Whisper logits (large-v3 widths, 2 + 2 layers, 64 tokens)", lc, lh, 1e-5,
        tag=f"{tag} (a)")
    del cut, cut_cpu, lc, lh, mel_cpu
    torch.cuda.empty_cache()

    # (b) the CTC aligner at wav2vec2-base-960h's widths
    w2v = build_w2v(dev)
    aligner = CTCWordAligner(w2v, device=dev)
    aligner_cpu = CTCWordAligner(cpu_copy(w2v, lambda: Wav2Vec2CTC(Wav2Vec2Config())),
                                 device="cpu")
    log(f"{tag} (b) CTCWordAligner, Wav2Vec2Config(): {n_params(w2v):.1f} M parameters fp32")
    x31 = _two_speakers(max(TR_SPANS) + 1.0, 16000)
    ids, _owner = aligner._encode_words(TR_WORDS)
    rec["aligner"] = {}
    for span in TR_SPANS:
        start, end = 0.5, 0.5 + span
        secs = []
        for i in range(1 + TR_WARM):
            reset_counts()
            words, s = timed(lambda: aligner.align_words(x31, 16000, start, end, TR_WORDS))
            launches = counts()
            expect(k2_only(launches, 12) and len(words) == len(TR_WORDS),
                   f"aligner {span} s: launches {launches}, {len(words)} words")
            if i == 0:
                for k in path:
                    path[k] += launches[k]
            secs.append(s)
        seg = x31[int(start * 16000):int(end * 16000)]
        lp, lp_cpu = aligner.log_probs(seg), aligner_cpu.log_probs(seg)
        expect(lp.shape[0] == hubert_frames(span), f"aligner {span} s: {lp.shape[0]} frames")
        err = card_vs_cpu(f"aligner log-probs ({span:g} s, {lp.shape[0]} frames)", lp, lp_cpu,
                          1e-5, tag=f"{tag} (b)")
        same = ctc_forced_align(lp, ids) == ctc_forced_align(lp_cpu, ids)
        expect(same, f"aligner {span} s: the CTC spans differ between the card and the CPU")
        rec["aligner"][span] = dict(seconds=secs, card_vs_cpu=err)
        log(f"{tag} (b) align_words over {span:g} s ({lp.shape[0]} frames, 12 words): cold "
            f"(a new length) {secs[0]:.4f} s, warm {', '.join(f'{s:.4f}' for s in secs[1:])} s; "
            f"12 K2; spans identical on the card and the CPU | {card}")
    del aligner_cpu

    # (c) PyanNet and its VAD; the diarizer's PyanNet back end
    pn = build_pyannet(dev)
    vad = pyannet_vad(pn, device=dev)
    secs = []
    for _ in range(1 + TR_WARM):
        regions, s = timed(lambda: vad(x60, 16000))
        secs.append(s)
    pn_cpu = cpu_copy(pn, lambda: PyanNet(PyanNetConfig()))
    wins = torch.from_numpy(np.pad(x60, (0, (-len(x60)) % 160000)).reshape(-1, 160000))
    with torch.inference_mode():
        lp, lp_cpu = pn(wins.to(dev)).cpu(), pn_cpu(wins)
    err = card_vs_cpu("PyanNet log-probs (6 windows of 10 s)", lp, lp_cpu, 1e-5,
                      tag=f"{tag} (c)")
    speech = powerset_to_multilabel(lp).amax(-1)
    speech_cpu = powerset_to_multilabel(lp_cpu).amax(-1)
    margin = (lp_cpu[..., 0] - lp_cpu[..., 1:].amax(-1)).abs()
    clear = margin > 10 * float((lp - lp_cpu).abs().max())
    expect(bool((speech == speech_cpu)[clear].all()),
           "PyanNet: a speech decision clear of a tie differs between the card and the CPU")
    rec["pyannet"] = dict(seconds=secs, regions=len(regions), card_vs_cpu=err)
    log(f"{tag} (c) pyannet_vad over 60 s, PyanNetConfig() ({n_params(pn):.2f} M): cold "
        f"{secs[0]:.4f} s, warm {', '.join(f'{s:.4f}' for s in secs[1:])} s; {len(regions)} "
        f"regions; {int(clear.sum())} of {clear.numel()} frames clear of a tie, their "
        f"decisions the same as the CPU's | {card}")
    diar = NeuralDiarizer(pyannet_params=pn.state_dict(), device=dev)
    x30 = _two_speakers(30.0, 16000)
    secs = []
    for _ in range(1 + TR_WARM):
        turns, s = timed(lambda: diar.diarize(x30, 16000))
        secs.append(s)
    rec["diarize_pyannet"] = secs
    log(f"{tag} (c) NeuralDiarizer(pyannet_params=...) on 30 s: cold {secs[0]:.4f} s, warm "
        f"{', '.join(f'{s:.4f}' for s in secs[1:])} s; {len(turns)} turns | {card}")
    del pn_cpu, diar

    # (d) multi-take alignment
    rng = np.random.default_rng(5)
    master_d = np.full(int(ALIGN_S / 0.5), 0.5)
    take_d = rng.uniform(0.4, 0.6, len(master_d))
    take_d *= ALIGN_S / take_d.sum()
    master, take = gliding_notes(master_d, 0), gliding_notes(take_d, 1)
    mw, tw = note_words(master_d), note_words(take_d)
    rtla = build_rtla(dev)
    rec["align"] = {}
    for label, model in (("chroma", None), ("chroma + RtlaCRNN phonemes", rtla)):
        secs = []
        for _ in range(1 + TR_WARM):
            (out, report), s = timed(lambda: align_take(master, take, 16000, mw, tw,
                                                        phoneme_model=model, device=dev))
            secs.append(s)
        expect(out.shape == master.shape and bool(np.isfinite(out).all())
               and report["matched"] == report["master_sentences"],
               f"align_take ({label}): {out.shape}, report {report}")
        rec["align"][label] = secs
        log(f"{tag} (d) align_take 30 s onto 30 s, {label}: cold {secs[0]:.3f} s, warm "
            f"{', '.join(f'{s:.3f}' for s in secs[1:])} s; {report['matched']} of "
            f"{report['master_sentences']} sentences matched | {card}")
    rtla_cpu = cpu_copy(rtla, lambda: RtlaCRNN(RtlaCRNNConfig()))
    rec["phonemes_card_vs_cpu"] = card_vs_cpu(
        "RtlaCRNN phoneme stream (30 s)", phoneme_features(master, 16000, rtla, device=dev),
        phoneme_features(master, 16000, rtla_cpu, device="cpu"), 1e-5, tag=f"{tag} (d)")
    del rtla, rtla_cpu

    # (e) the served routes, then main --demo-backends
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_transcribe_"))
    wavs = {}
    for name, x in (("talk.wav", x60), ("master.wav", master), ("take.wav", take)):
        write_wav(work / name, x, 16000)
        wavs[name] = {"filename": name,
                      "content": base64.b64encode((work / name).read_bytes()).decode()}
    saved = dict(transcribe_api._BACKENDS), list(align_api._TRANSCRIBER)
    served = Transcriber(whisper, aligner=aligner, vad=vad, device=dev)
    server, port = serve_background(create_app(str(work / "process"), device=dev))
    url = f"http://127.0.0.1:{port}"
    rec["served"] = {}
    try:
        transcribe_api.register_backend("whisper", served)
        align_api.register_transcriber(served)
        reset_counts()
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/api/v1/audio/transcriptions",
                            {"model": "whisper", "files": [wavs["talk.wav"]],
                             "settings": {"response_format": "srt"}})
        sync(dev)
        secs = time.perf_counter() - t0
        launches = counts()
        expect(status == 200, f"transcriptions: HTTP {status} {resp.get('error')}")
        segs = resp["results"][0]["segments"]
        # the segments the aligner runs on: 40 ms or more of the audio
        aligned = sum(1 for s in segs if min(len(x60), int(s["end"] * 16000))
                      - max(0, int(s["start"] * 16000)) >= 16000 // 25)
        expect(k2_only(launches, 12 * aligned),
               f"transcriptions: launches {launches} for {aligned} aligned segments")
        rec["served"]["transcriptions"] = dict(seconds=secs, segments=len(segs))
        log(f"{tag} (e) POST /api/v1/audio/transcriptions (60 s, Whisper large-v3 widths, "
            f"the aligner, the VAD): HTTP {status} {secs:.3f} s; {len(segs)} segments "
            f"({aligned} through the aligner), {len(resp['results'][0]['text'])} characters; "
            f"launches {launches} | {card}")
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/api/v1/align",
                            {"files": [wavs["master.wav"], wavs["take.wav"]]})
        secs = time.perf_counter() - t0
        expect(status == 200, f"align: HTTP {status} {resp.get('error')}")
        (work / "aligned.wav").write_bytes(base64.b64decode(resp["results"][0]["content"]))
        a = read_wav(work / "aligned.wav")
        expect(a.samples.shape[-1] == len(master) and bool(np.isfinite(a.samples).all()),
               f"align: {a.samples.shape} against {len(master)} samples")
        rec["served"]["align"] = secs
        log(f"{tag} (e) POST /api/v1/align (30 s master, 30 s take; words from the served "
            f"transcriber, else energy pseudo-words): HTTP {status} {secs:.3f} s; report "
            f"{ {k: v for k, v in resp['results'][0]['report'].items() if k != 'pairs'} } | "
            f"{card}")
    finally:
        server.shutdown()
        server.server_close()
        transcribe_api._BACKENDS.clear()
        transcribe_api._BACKENDS.update(saved[0])
        align_api._TRANSCRIBER[:] = saved[1]
    del whisper, served, aligner, vad, w2v
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    out = open(work / "main.log", "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiolab_tpu_torch.main", "--port", str(mport),
         "--output-root", str(work / "main" / "process"), "--device", dev.type,
         "--demo-backends"],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT)
    try:
        murl = f"http://127.0.0.1:{mport}"
        while True:
            try:
                status, _doc = http("GET", f"{murl}/openapi.json", timeout=30)
                break
            except (urllib.error.URLError, ConnectionError):
                expect(proc.poll() is None and time.perf_counter() - t0 < 180,
                       f"main --demo-backends: not serving (exit {proc.poll()}): "
                       f"{(work / 'main.log').read_text()[-2000:]}")
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        status, resp = http("POST", f"{murl}/api/v1/audio/transcriptions",
                            {"model": "whisper", "files": [wavs["master.wav"]]})
        req_s = time.perf_counter() - t1
        expect(status == 200 and "segments" in resp["results"][0],
               f"main whisper: HTTP {status} {resp.get('error')}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        log(f"{tag} (e) python -m audiolab_tpu_torch.main --demo-backends: serving after "
            f"{up_s:.3f} s; POST transcriptions 'whisper' (30 s) {req_s:.3f} s, "
            f"{len(resp['results'][0]['segments'])} segments; SIGTERM -> exit {rc}")
        expect(rc == 0, f"main --demo-backends: exit {rc}: "
                        f"{(work / 'main.log').read_text()[-2000:]}")
        rec["served"]["main_whisper"] = req_s
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        shutil.rmtree(work, ignore_errors=True)
    rec["launches"] = path
    log(f"{tag} the path's launches ((a)'s uncached forward and (b)'s first call of each "
        f"span): {path}")
    expect(path["K2"] > 0 or not cuda, "transcribe: K2 was not launched on the path")
    return rec


# ---------------------------------------------------------------- diffusion

DIFF_WT_STEPS = 20          # the served WaveTransfer job's steps
DIFF_RESUME_STEPS = 10      # the resumed job's further steps
DIFF_GEN_S = 30.0           # seconds of source audio to generate from
DIFF_BDDM_STEPS = 10        # schedule-net steps
DIFF_SR_STEPS = 5           # super-resolution training steps
DIFF_SR_S = 20.0            # seconds of stereo through the Super Resolution route
DIFF_DDIM_STEPS = 50


def _wav_payload(work: Path, name: str, x: np.ndarray, sr: int) -> dict:
    import base64

    from audiolab_tpu_torch.core.audio_io import write_wav

    write_wav(work / name, x, sr)
    return {"filename": name, "content": base64.b64encode((work / name).read_bytes()).decode()}


def _served_wav(work: Path, content: str, name: str):
    import base64

    from audiolab_tpu_torch.core.audio_io import read_wav

    (work / name).write_bytes(base64.b64decode(content))
    return read_wav(work / name)


def phase_diffusion(dev, card: str, profile_dir: str | None = None) -> dict:
    """WaveTransfer and both learned enhancers of Super Resolution at their
    published widths, fp32 with TF32 off, weights by bench.py's rules
    (utils/fast_init.py) or flax's initialisers (WaveGrad training).  (a)
    WaveTransfer at WTConfig() (24 kHz, 128 mels, hop 300, batch 8 of 7,200
    samples): a served POST /api/v1/wavetransfer/train of DIFF_WT_STEPS
    steps on 2 x 10 s of tones, polled to done (first and warm step
    seconds), a resume to DIFF_WT_STEPS + DIFF_RESUME_STEPS, POST
    /api/v1/wavetransfer/generate on 30 s with fast6 and fast12 (40 chunks
    of 64 frames), DIFF_BDDM_STEPS schedule-net steps and the schedule
    search; one chunk's FAST_6 sample on the card against the CPU with the
    same draws.  (b) Super Resolution by WaveGrad: train_superres for
    DIFF_SR_STEPS steps at 48 kHz, load_enhancer, POST
    /api/v1/process/super_resolution on 20 s of stereo, cold and warm.  (c)
    AudioSR at the published widths (VAE ch 128 x (1, 2, 4, 8), z 16; UNet
    model 128 x (1, 2, 3, 5), attention at 2/4/8; vocoder 1536 channels,
    rates 6, 5, 4, 2, 2): enhance_chunks on one 10.24 s stereo chunk, 50
    DDIM steps at guidance 3.5, cold and warm with peak memory; one guided
    DDIM step on the card against the CPU; the Super Resolution route with
    ckpt_pipeline set on 20 s of stereo.  Counts are reset before each
    step and read after it; the path launches none of K1-K7.  With
    ``profile_dir``, profiler tables of a warm WaveGrad training step, of
    FAST_6 over the 40 chunks and of one enhance_chunks call.  Returns the
    path's launches."""
    import copy
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.models import wavegrad as WG
    from audiolab_tpu_torch.pipelines.processors.super_res import SuperResolution
    from audiolab_tpu_torch.pipelines.super_res import AudioSRCheckpointPipeline, ddim_timesteps
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.train import super_res as SRT
    from audiolab_tpu_torch.train import wavetransfer as WT

    cuda = dev.type == "cuda"
    tag = "[diffusion]"
    rec: dict = {"served": {}}
    path = dict.fromkeys(KERNELS, 0)

    def add(launches: dict, label: str) -> None:
        for k in KERNELS:
            path[k] += launches[k]
        expect(not any(launches.values()), f"{label}: launches {launches}, expected none")

    def timed(fn):
        reset_counts()
        _peak_reset(cuda)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0, counts(), _peak_gb(cuda)

    def job(url: str, body: dict, label: str) -> tuple[dict, float]:
        reset_counts()
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/wavetransfer/train", body)
        expect(status == 200, f"{label}: HTTP {status} {resp}")
        while True:
            time.sleep(0.25)
            status, info = http("GET", f"{url}/rvc/job/{resp['job_id']}")
            if info.get("status") != "running":
                break
        secs = time.perf_counter() - t0
        add(counts(), label)
        expect(info.get("status") == "done", f"{label}: job {info}")
        return info["result"], secs

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_diffusion_"))
    slots = (SuperResolution.enhancer_fn, SuperResolution.ckpt_pipeline)
    server = None
    try:
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        url = f"http://127.0.0.1:{port}/api/v1"
        cfg = WT.WTConfig()
        proj = work / "wavetransfer" / "voice"

        # (a) WaveTransfer: train, resume, generate, BDDM
        files = [_wav_payload(work, f"take{i}.wav", harmonic_tone(24000, 240000, 110.0 + 50 * i,
                                                                  40 + i), 24000)
                 for i in range(2)]
        settings = {"sr": 24000, "batch_size": 8, "ckpt_every": 10}
        for label, body in (
                ("train", {"project": "voice", "files": files,
                           "settings": settings | {"steps": DIFF_WT_STEPS}}),
                ("resume", {"project": "voice",
                            "settings": settings | {"steps": DIFF_WT_STEPS + DIFF_RESUME_STEPS}})):
            res, secs = job(url, body, f"wavetransfer/{label}")
            steps = sorted(int(p.stem.split("_")[1]) for p in (proj / "ckpt").glob("ckpt_*.pt"))
            log(f"{tag} (a) POST wavetransfer/{label} at WTConfig() (batch 8 x 7200 at 24 kHz, "
                f"{sum(p.numel() for p in WG.WaveGrad(cfg.model).parameters()) / 1e6:.1f} M "
                f"parameters) to step {res['steps']}: job {secs:.3f} s, first step "
                f"{res['first_step_s']:.3f} s, warm step {res['warm_step_s'] * 1e3:.2f} ms, loss "
                f"{res['loss']:.4f}, checkpoints {steps} | {card}")
            expect(res["steps"] == body["settings"]["steps"] and np.isfinite(res["loss"])
                   and steps[-1] == res["steps"], f"wavetransfer/{label}: {res}, {steps}")
            rec["served"][label] = dict(job_s=secs, first_step_s=res["first_step_s"],
                                        warm_step_s=res["warm_step_s"])
        src = harmonic_tone(24000, int(DIFF_GEN_S * 24000), 150.0, 42)
        gen = [_wav_payload(work, "src.wav", src, 24000)]
        for sched in ("fast6", "fast12", "fast6"):
            reset_counts()
            t0 = time.perf_counter()
            status, resp = http("POST", f"{url}/wavetransfer/generate",
                                {"project": "voice", "files": gen,
                                 "settings": {"sr": 24000, "schedule": sched}})
            secs = time.perf_counter() - t0
            expect(status == 200, f"wavetransfer/generate {sched}: HTTP {status} {resp}")
            add(counts(), f"wavetransfer/generate {sched}")
            a = _served_wav(work, resp["audio"], "gen.wav")
            expect(a.samples.shape == (1, len(src)) and bool(np.isfinite(a.samples).all()),
                   f"generate {sched}: {a.samples.shape}")
            log(f"{tag} (a) POST wavetransfer/generate {sched} on {DIFF_GEN_S:.0f} s "
                f"({-(-(len(src) - 1200) // 18000)} chunks of 19200): {secs:.3f} s, "
                f"{DIFF_GEN_S / secs:.1f} audio-s/s, peak |y| {float(np.abs(a.samples).max()):.3f}")
            rec["served"].setdefault(f"generate_{sched}", []).append(secs)

        model = WT.load_ema(str(proj / "ckpt"), cfg.model, dev)
        batches = WT._load_segments(str(proj), cfg, np.random.default_rng(1), dev)
        audio, mel = next(batches)
        (net, losses), secs, launches, peak = timed(
            lambda: WT.train_schedule_net(model, audio, mel, steps=DIFF_BDDM_STEPS, lr=1e-4))
        add(launches, "bddm train")
        expect(all(np.isfinite(losses)), f"bddm losses {losses}")
        sched, secs2, launches, _ = timed(lambda: WT.bddm_noise_scheduling(model, net, mel[:1]))
        add(launches, "bddm search")
        log(f"{tag} (a) BDDM: {DIFF_BDDM_STEPS} schedule-net steps at batch 8 in {secs:.3f} s "
            f"(losses {losses[0]:.4g} -> {losses[-1]:.4g}, peak {peak:.2f} GB); the schedule "
            f"search {secs2:.3f} s -> {len(sched.betas)} betas "
            f"{[float(f'{b:.3g}') for b in sched.betas]}")
        rec["bddm_s"] = (secs, secs2)

        chunk_mel = WT._mel_of(torch.from_numpy(src[:19200]).to(dev)[None], cfg)
        draws = WG.sample_draws(6, 1, 19200, 3, torch.device("cpu"))
        out, secs, launches, _ = timed(
            lambda: WG.sample(model, chunk_mel, WG.FAST_6, draws=draws.to(dev)))
        add(launches, "sample")
        ref = WG.sample(copy.deepcopy(model).cpu(), chunk_mel.cpu(), WG.FAST_6, draws=draws)
        rec["sample_err"] = card_vs_cpu("one chunk's FAST_6 sample (64 frames, WaveGrad at "
                                        "WTConfig())", out.cpu(), ref, 1e-3, tag=f"{tag} (a)")
        log(f"{tag} (a) one chunk's FAST_6 sample on the card: {secs * 1e3:.1f} ms")
        if profile_dir:
            scale, eps = WG.loss_draws(8, audio.shape[-1], 0, dev)

            def train_step():
                model.zero_grad(set_to_none=True)
                WG.diffusion_loss(model, audio, mel, scale, eps).backward()

            train_step()
            step_s = timed(train_step)[1]
            profile_call("wavegrad train step", train_step, {"step": step_s}, dev, profile_dir,
                         card, tag)
            chunks = WT._mel_of(torch.from_numpy(src[:40 * 18000 + 1200]).to(dev).unfold(
                0, 19200, 18000), cfg)
            sample_s = timed(lambda: WG.sample(model, chunks, WG.FAST_6))[1]
            profile_call("wavegrad FAST_6 on 40 chunks",
                         lambda: WG.sample(model, chunks, WG.FAST_6), {"sample": sample_s},
                         dev, profile_dir, card, tag)
        del model, net, batches, audio, mel

        # (b) Super Resolution by WaveGrad
        data = work / "sr_data"
        data.mkdir()
        for i in range(2):
            write_wav(data / f"music{i}.wav",
                      harmonic_tone(48000, 8 * 48000, 220.0 * (i + 1), 50 + i), 48000)
        sr_cfg = SRT.SRTrainConfig(wt=WT.WTConfig(sr=48000, steps=DIFF_SR_STEPS,
                                                  ckpt_every=DIFF_SR_STEPS))
        res, secs, launches, peak = timed(lambda: SRT.train_superres(str(data), sr_cfg, device=dev))
        add(launches, "train_superres")
        log(f"{tag} (b) train_superres at 48 kHz, batch 8 x 7200, {DIFF_SR_STEPS} steps: "
            f"{secs:.3f} s, first step {res['first_step_s']:.3f} s, warm step "
            f"{res['warm_step_s'] * 1e3:.2f} ms, loss {res['loss']:.4f}, peak {peak:.2f} GB")
        SuperResolution.configure(enhancer_fn=SRT.load_enhancer(str(data), sr_cfg, device=dev))
        stereo = np.stack([harmonic_tone(44100, int(DIFF_SR_S * 44100), 196.0, 60),
                           harmonic_tone(44100, int(DIFF_SR_S * 44100), 247.0, 61)])
        song = [_wav_payload(work, "song.wav", stereo, 44100)]

        def super_resolution(label: str) -> list[float]:
            times = []
            for rep in ("cold", "warm"):
                reset_counts()
                _peak_reset(cuda)
                t0 = time.perf_counter()
                status, resp = http("POST", f"{url}/process/super_resolution", {"files": song})
                secs = time.perf_counter() - t0
                expect(status == 200, f"{label}: HTTP {status} {resp}")
                add(counts(), label)
                a = _served_wav(work, resp["files"][0]["content"], "sr.wav")
                want = (2, int(DIFF_SR_S * 48000))
                expect(a.sample_rate == 48000 and a.samples.shape == want
                       and bool(np.isfinite(a.samples).all()), f"{label}: {a.samples.shape}")
                log(f"{tag} {label} {rep}: {secs:.3f} s ({DIFF_SR_S:.0f} s stereo, 2 chunks of "
                    f"10.24 s), peak {_peak_gb(cuda):.2f} GB | {card}")
                times.append(secs)
            return times

        rec["served"]["super_res_wavegrad"] = super_resolution(
            "(b) POST process/super_resolution, WaveGrad enhancer")
        SuperResolution.configure()

        # (c) AudioSR at the published widths
        vae, unet, voc = build_audiosr(dev)
        n_params = [sum(p.numel() for p in m.parameters()) / 1e6 for m in (vae, unet, voc)]
        pipe = AudioSRCheckpointPipeline(vae, unet, voc)
        chunk = torch.from_numpy(stereo[None, :, :491520].copy()).to(dev)
        times = []
        for rep in ("cold", "warm"):
            out, secs, launches, peak = timed(
                lambda: pipe.enhance_chunks(chunk, steps=DIFF_DDIM_STEPS, seed=1))
            add(launches, "enhance_chunks")
            expect(tuple(out.shape) == (1, 2, 491520) and bool(torch.isfinite(out).all()),
                   f"enhance_chunks {tuple(out.shape)}")
            times.append(secs)
            log(f"{tag} (c) AudioSR enhance_chunks at the published widths (VAE / UNet / "
                f"vocoder {n_params[0]:.1f} / {n_params[1]:.1f} / {n_params[2]:.1f} M), one "
                f"10.24 s stereo chunk, {DIFF_DDIM_STEPS} DDIM steps at guidance 3.5 (UNet "
                f"batch 4 on 16 x 128 x 32 latents) {rep}: {secs:.3f} s, peak {peak:.2f} GB | "
                f"{card}")
        rec["audiosr_s"] = times
        if profile_dir:
            profile_call("audiosr enhance_chunks", lambda: pipe.enhance_chunks(
                chunk, steps=DIFF_DDIM_STEPS, seed=1), {"enhance": times[-1]}, dev, profile_dir,
                card, tag)
        t_seq = ddim_timesteps(1000, 50)          # the check steps from t_seq[10] to [11]
        gen = torch.Generator().manual_seed(2)
        z = torch.randn((1, 16, 32, 32), generator=gen)
        cond = torch.cat([torch.randn((1, 16, 32, 32), generator=gen),
                          torch.full((1, 16, 32, 32), -11.4981)])
        x = torch.cat([torch.cat([z, z]), cond], dim=1)
        tt = torch.full((2,), float(t_seq[10]))
        cpu_pipe = AudioSRCheckpointPipeline(None, copy.deepcopy(unet).cpu(), None)
        with torch.inference_mode():
            rec["unet_err"] = card_vs_cpu(
                "the UNet's v (AudioSRUNetConfig(), batch 2 on 32 x 32 x 32)",
                unet(x.to(dev), tt.to(dev)).cpu(), cpu_pipe.unet(x, tt), 1e-4, tag=f"{tag} (c)")
        rec["ddim_err"] = card_vs_cpu(
            "one guided DDIM step from it", pipe.ddim_step(z.to(dev), cond.to(dev), t_seq[10],
                                                            t_seq[11]).cpu(),
            cpu_pipe.ddim_step(z, cond, t_seq[10], t_seq[11]), 1e-5, tag=f"{tag} (c)")
        del cpu_pipe
        SuperResolution.configure(ckpt_pipeline=pipe)
        rec["served"]["super_res_audiosr"] = super_resolution(
            "(c) POST process/super_resolution, AudioSR ckpt_pipeline")
    finally:
        SuperResolution.enhancer_fn, SuperResolution.ckpt_pipeline = slots
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    rec["launches"] = path
    log(f"{tag} the path's launches (every step above): {path}")
    return rec


# ---------------------------------------------------------------- music

MUSIC_SAO_S = 47.0           # stable-audio-open's longest generation
MUSIC_SAO_STEPS = 8          # of the published sampler's 100
MUSIC_SA_S = 47.0
MUSIC_SA_STEPS = 8           # of generate_audio's 50
MUSIC_ACE_S = 30.0
MUSIC_REPAINT_S = (10.0, 20.0)
MUSIC_SERVED_S = 10.0
MUSIC_CHECK_FRAMES = 200     # latent frames of the card-against-CPU checks
MUSIC_PROMPT = "warm analog pads over a slow hip hop beat, vinyl crackle"
MUSIC_LYRICS = "[verse] walking through the night [chorus] we are the light"


def music_spm_model(path: Path) -> str:
    """A SentencePiece model in T5's id layout (<pad> 0, </s> 1, <unk> 2),
    written with the port's ``build_model_proto``: T5's tokenizer file is
    not in the repository, and with random weights any vocabulary serves."""
    from audiolab_tpu_torch.utils.spm import build_model_proto

    words = sorted(set(MUSIC_PROMPT.replace(",", "").split()))
    pieces = ([("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -3.0, 1)]
              + [(f"▁{w}", -1.0, 1) for w in words]
              + [(c, -4.0, 1) for c in "abcdefghijklmnopqrstuvwxyz,"])
    path.write_bytes(build_model_proto(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0))
    return str(path)


def phase_music(dev, card: str) -> dict:
    """Music generation on the DiT family at published widths, weights by
    bench.py's rules (utils/fast_init.py), cut only in sampler steps: (a)
    StableAudioCheckpointPipeline at stable-audio-open-1.0's geometry
    (SAODiTConfig(): 1536 x 24 layers, 24 heads, fp32; T5-base; the
    checkpoint Oobleck decoder, 128 x (1, 2, 4, 8, 16)) on 47 s with
    DPM++ 3M SDE, MUSIC_SAO_STEPS of the published 100 steps: one fp32 K2 a
    layer a guided step; (b) the in-repo StableAudioModel at
    StableAudioConfig() (DiT 1024 x 16 layers x 16 heads, bf16) through
    generate_audio on 47 s, MUSIC_SA_STEPS of 50 steps: one 16-bit K2 a
    layer a step, on the Hopper route; (c) ACEStepPipeline at
    ACEStepConfig() (the DiT 1024 x 16 x 16 bf16, DCAE 64 x 3, Vocos 512 x
    8 at n_fft 2048, hop 512) generate on 30 s at the default 27 Euler
    steps, then a repaint of 10-20 s; each call cold and warm with its
    seconds, peak memory and launches (counts reset just before and read
    just after); seconds per guided step from one DiT call timed with CUDA
    events; (d) POST /api/v1/audio/generate and POST
    /api/v1/acestep/generate on 10 s through create_app; (e) card against
    CPU at 2 layers of each DiT over MUSIC_CHECK_FRAMES frames: the SAO DiT
    (fp32) and one guided DPM++ step, the in-repo DiT (bf16) and one
    ACE-Step Euler step (bf16).  Returns the path's launches: (a)-(c)'s
    cold calls, the repaint and (d)'s two requests (the 10 s ACE-Step clip's
    108 frames fit one key block and take K1)."""
    import copy
    import tempfile

    import torch

    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.models.acestep import ACEStepConfig, ACEStepModel, fm_sample
    from audiolab_tpu_torch.models.codecs import VocosConfig
    from audiolab_tpu_torch.models.dit import DiTConfig
    from audiolab_tpu_torch.models.ksampler import (
        sample_dpmpp_3m_sde,
        sigmas_polyexponential,
        v_denoiser,
    )
    from audiolab_tpu_torch.models.stable_audio import StableAudioConfig
    from audiolab_tpu_torch.models.stable_audio_dit import SAODiTConfig, StableAudioDiT
    from audiolab_tpu_torch.pipelines.acestep import random_acestep
    from audiolab_tpu_torch.pipelines.music import (
        random_stable_audio,
        random_stable_audio_checkpoint,
    )
    from audiolab_tpu_torch.serve import music_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    tag = "[music]"
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)

    def timed(fn):
        reset_counts()
        h0 = A.flash_attention_fwd.sm90_launches
        _peak_reset(cuda)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return (out, time.perf_counter() - t0, counts(),
                A.flash_attention_fwd.sm90_launches - h0, _peak_gb(cuda))

    def event_ms(fn) -> float:
        return cuda_ms(fn, iters=3) if cuda else float("nan")

    def run(label: str, fn, k2: int, hopper: bool, first: bool) -> tuple:
        """One call: seconds, peak, launches; on the path when ``first``."""
        out, secs, launches, sm90, peak = timed(fn)
        log(f"{tag} {label}: {secs:.3f} s, peak {peak:.2f} GB, launches {launches} "
            f"({sm90} on K2's Hopper route) | {card}")
        if cuda:     # the plain versions on the CPU count nothing
            expect(only(launches, "K2", k2), f"{label}: launches {launches}, expected K2 {k2}")
            expect(sm90 == (k2 if hopper else 0), f"{label}: {sm90} K2 on the Hopper route")
        if first:
            for k in KERNELS:
                path[k] += launches[k]
        return out, secs, peak

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_music_"))
    spm = music_spm_model(work / "t5.model")

    # (a) stable-audio-open-1.0's geometry through the checkpoint pipeline
    t0 = time.perf_counter()
    sao = random_stable_audio_checkpoint(spm, device=dev)
    sync(dev)
    n_dit = sum(p.numel() for p in sao.dit.parameters())
    n_dec = sum(p.numel() for p in sao.decoder.parameters())
    log(f"{tag} (a) StableAudioCheckpointPipeline built in {time.perf_counter() - t0:.1f} s: "
        f"SAO DiT {n_dit / 1e9:.3f} B, Oobleck decoder {n_dec / 1e6:.1f} M, T5-base "
        f"{sum(p.numel() for p in sao.t5.parameters()) / 1e6:.1f} M parameters, fp32")
    depth = sao.dit_cfg.depth
    t_lat = sao.latent_frames(MUSIC_SAO_S)
    kw = dict(seconds_total=MUSIC_SAO_S, steps=MUSIC_SAO_STEPS, cfg_scale=7.0, seed=0,
              negative_prompt="")
    secs = []
    for i in range(2):
        (y, sr), s, peak = run(f"(a) generate {MUSIC_SAO_S:g} s, dpmpp-3m-sde, "
                               f"{MUSIC_SAO_STEPS} steps ({'cold' if i == 0 else 'warm'})",
                               lambda: sao.generate(MUSIC_PROMPT, **kw),
                               MUSIC_SAO_STEPS * depth, False, i == 0)
        secs.append(s)
    expect(y.shape == (2, t_lat * 2048) and np.isfinite(y).all() and sr == 44100,
           f"(a) output {y.shape}, finite {np.isfinite(y).all()}")
    cross, glob = sao.conditioning([MUSIC_PROMPT], 0.0, MUSIC_SAO_S)
    cross2, glob2 = torch.cat([cross, torch.zeros_like(cross)]), torch.cat([glob, glob])
    x2 = torch.randn(2, t_lat, 64, device=dev)
    with torch.inference_mode():
        step_ms = event_ms(lambda: sao.dit(x2, torch.full((2,), 0.5, device=dev), cross2,
                                           glob2))
        z = torch.randn(1, t_lat, 64, device=dev)
        dec_ms = event_ms(lambda: sao.decoder(z))
    rec["sao"] = dict(cold_s=secs[0], warm_s=secs[1], peak_gb=peak, step_ms=step_ms,
                      decoder_ms=dec_ms, k2_per_call=MUSIC_SAO_STEPS * depth)
    log(f"{tag} (a) {t_lat} latents (+1 global token: {t_lat + 1} positions), a guided step "
        f"(CFG batch 2) {step_ms:.2f} ms, the Oobleck decoder on {MUSIC_SAO_S:g} s "
        f"{dec_ms:.2f} ms; cold {secs[0]:.3f} s, warm {secs[1]:.3f} s "
        f"({secs[1] / MUSIC_SAO_S:.4f} s per second of audio); K2 per call "
        f"{MUSIC_SAO_STEPS * depth} (fp32, none on the Hopper route); output "
        f"{y.shape} peak |y| {np.abs(y).max():.3e} | {card}")
    del sao, y, cross2, glob2, x2, z
    torch.cuda.empty_cache() if cuda else None

    # (b) the in-repo Stable Audio at StableAudioConfig()
    t0 = time.perf_counter()
    sa = random_stable_audio(StableAudioConfig(), device=dev)
    sync(dev)
    log(f"{tag} (b) StableAudioModel at StableAudioConfig() built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in sa.model.parameters()) / 1e6:.1f} M parameters (DiT "
        f"{sum(p.numel() for p in sa.model.dit.parameters()) / 1e6:.1f} M, bf16 compute)")
    n_layers = sa.cfg.dit.n_layers
    secs = []
    for i in range(2):
        (y, sr), s, peak = run(f"(b) generate_audio {MUSIC_SA_S:g} s, DDIM {MUSIC_SA_STEPS} "
                               f"steps ({'cold' if i == 0 else 'warm'})",
                               lambda: sa.generate(MUSIC_PROMPT, seconds_total=MUSIC_SA_S,
                                                   steps=MUSIC_SA_STEPS, seed=1),
                               MUSIC_SA_STEPS * n_layers, True, i == 0)
        secs.append(s)
    t_sa = round(MUSIC_SA_S * 44100 / 2048)
    expect(y.shape == (2, t_sa * 2048) and np.isfinite(y).all(), f"(b) output {y.shape}")
    ctx = torch.randn(2, 130, 768, device=dev)
    zz = torch.randn(2, t_sa, 64, device=dev)
    with torch.inference_mode():
        step_ms = event_ms(lambda: sa.model.denoise(zz, torch.full((2,), 0.5, device=dev), ctx))
    rec["stable_audio"] = dict(cold_s=secs[0], warm_s=secs[1], peak_gb=peak, step_ms=step_ms,
                               k2_per_call=MUSIC_SA_STEPS * n_layers)
    log(f"{tag} (b) {t_sa} latents, a guided step (CFG batch 2) {step_ms:.2f} ms; cold "
        f"{secs[0]:.3f} s, warm {secs[1]:.3f} s; K2 per call {MUSIC_SA_STEPS * n_layers}, all "
        f"on the Hopper route (bf16, d = 64) | {card}")
    del y, ctx, zz

    # (c) ACE-Step at ACEStepConfig()
    t0 = time.perf_counter()
    ace = random_acestep(ACEStepConfig(), vocos_cfg=VocosConfig(n_fft=2048, hop=512),
                         device=dev)
    sync(dev)
    log(f"{tag} (c) ACEStepPipeline at ACEStepConfig() built in {time.perf_counter() - t0:.1f}"
        f" s: {sum(p.numel() for p in ace.model.parameters()) / 1e6:.1f} M parameters, Vocos "
        f"{sum(p.numel() for p in ace.vocos.parameters()) / 1e6:.1f} M")
    steps, n_layers = ace.pcfg.steps, ace.cfg.dit.n_layers
    secs = []
    for i in range(2):
        (y, sr), s, peak = run(f"(c) generate {MUSIC_ACE_S:g} s, Euler {steps} steps "
                               f"({'cold' if i == 0 else 'warm'})",
                               lambda: ace.generate(MUSIC_PROMPT, lyrics=MUSIC_LYRICS,
                                                    duration=MUSIC_ACE_S, seed=2),
                               steps * n_layers, True, i == 0)
        secs.append(s)
    frames = ace._frames(MUSIC_ACE_S)
    expect(np.isfinite(y).all() and y.shape == ((frames * 8 - 1) * 512,),
           f"(c) output {y.shape}")
    song = y
    (y, sr), rs, peak_r = run(f"(c) repaint {MUSIC_REPAINT_S[0]:g}-{MUSIC_REPAINT_S[1]:g} s of "
                              f"the {MUSIC_ACE_S:g} s song", lambda: ace.repaint(
                                  song, MUSIC_PROMPT, *MUSIC_REPAINT_S, seed=3),
                              steps * n_layers, True, True)
    expect(np.isfinite(y).all(), "(c) repaint not finite")
    ctx2 = ace._context2(MUSIC_PROMPT, MUSIC_LYRICS)
    z2 = torch.randn(2, frames, 8, device=dev)
    with torch.inference_mode():
        step_ms = event_ms(lambda: ace.model.velocity(z2, torch.full((2,), 0.5, device=dev),
                                                      ctx2))
    rec["acestep"] = dict(cold_s=secs[0], warm_s=secs[1], repaint_s=rs, peak_gb=peak,
                          step_ms=step_ms, k2_per_call=steps * n_layers)
    log(f"{tag} (c) {frames} latent frames, a guided step (CFG batch 2) {step_ms:.2f} ms; "
        f"generate cold {secs[0]:.3f} s, warm {secs[1]:.3f} s ({MUSIC_ACE_S / secs[1]:.1f} "
        f"audio-s/s), repaint {rs:.3f} s; K2 per call {steps * n_layers}, all on the Hopper "
        f"route | {card}")

    # (d) the served routes
    saved = dict(music_api._BACKENDS)
    server = None
    try:
        music_api._BACKENDS.clear()
        music_api.register_backend("stable_audio", sa)
        music_api.register_backend("acestep", ace)
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        url = f"http://127.0.0.1:{port}/api/v1"
        rec["served"] = {}
        # the in-repo DiT over 215 latents takes K2; ACE-Step's over 108
        # frames fits one 128-key block and takes K1, both on the Hopper route
        for route, body, t_keys, n in (
                ("audio/generate", {"prompt": MUSIC_PROMPT, "settings": {
                    "seconds_total": MUSIC_SERVED_S, "steps": MUSIC_SA_STEPS}},
                 round(MUSIC_SERVED_S * 44100 / 2048), MUSIC_SA_STEPS * sa.cfg.dit.n_layers),
                ("acestep/generate", {"prompt": MUSIC_PROMPT, "lyrics": MUSIC_LYRICS,
                                      "duration": MUSIC_SERVED_S},
                 ace._frames(MUSIC_SERVED_S), steps * ace.cfg.dit.n_layers)):
            kern, wrapper = (("K2", A.flash_attention_fwd) if t_keys > 128
                             else ("K1", A.attention_nk1))
            reset_counts()
            h0 = wrapper.sm90_launches
            t0 = time.perf_counter()
            status, resp = http("POST", f"{url}/{route}", body)
            secs = time.perf_counter() - t0
            launches = counts()
            sm90 = wrapper.sm90_launches - h0
            expect(status == 200, f"POST {route}: HTTP {status} {resp}")
            a = _served_wav(work, resp["audio"], "served.wav")
            expect(a.samples.shape[-1] > 0 and np.isfinite(a.samples).all(), f"{route} WAV")
            log(f"{tag} (d) POST /api/v1/{route} ({MUSIC_SERVED_S:g} s): HTTP {status} "
                f"{secs:.3f} s, {a.samples.shape} at {a.sample_rate} Hz, launches {launches} "
                f"({sm90} on {kern}'s Hopper route) | {card}")
            if cuda:
                expect(only(launches, kern, n), f"POST {route}: launches {launches}, "
                       f"expected {kern} {n}")
                expect(sm90 == n, f"POST {route}: {sm90} {kern} on the Hopper route")
            for k in KERNELS:
                path[k] += launches[k]
            rec["served"][route] = dict(seconds=secs, kernel=kern, launches=launches[kern])
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        music_api._BACKENDS.clear()
        music_api._BACKENDS.update(saved)
    del sa, ace, song, y, ctx2, z2
    torch.cuda.empty_cache() if cuda else None

    # (e) card against CPU at 2 layers of each DiT
    if cuda:
        cpu = torch.device("cpu")
        g = torch.Generator().manual_seed(5)
        n = MUSIC_CHECK_FRAMES
        with torch.device(dev):
            sao_dit = fast_init(StableAudioDiT(SAODiTConfig(depth=2)), 6)
        args = (torch.randn(2, n, 64, generator=g), torch.tensor([0.4, 0.4]),
                0.5 * torch.randn(2, 130, 768, generator=g), torch.randn(2, 1536, generator=g))
        sig = sigmas_polyexponential(4, 0.3, 500.0)
        draws = torch.randn(4, 1, n, 64, generator=g)
        outs = {}
        for d in (dev, cpu):
            m = sao_dit if d == dev else copy.deepcopy(sao_dit).to(cpu)
            a = tuple(x.to(d) for x in args)
            with torch.inference_mode():
                v = m(*a)

                def guided(x, t, m=m, a=a):
                    vv = m(torch.cat([x, x]), torch.full((2,), t, device=x.device), a[2], a[3])
                    return vv[1:] + 7.0 * (vv[:1] - vv[1:])

                x1 = sample_dpmpp_3m_sde(v_denoiser(guided), a[0][:1] * float(sig[0]),
                                         sig[:2], draws=draws[:1].to(d))
            outs["card" if d is dev else "cpu"] = (v.cpu(), x1.cpu())
        rec["card_vs_cpu"] = {
            "sao_forward": card_vs_cpu("SAO DiT forward, 2 of 24 layers at full width",
                                       outs["card"][0], outs["cpu"][0], 1e-5, tag=f"{tag} (e)"),
            "sao_step": card_vs_cpu("one guided DPM++ 3M SDE step", outs["card"][1],
                                    outs["cpu"][1], 1e-5, tag=f"{tag} (e)")}
        del sao_dit
        cfg = ACEStepConfig(dit=DiTConfig(dim=1024, n_layers=2, n_heads=16, cond_dim=768,
                                          in_dim=8, out_dim=8), text_layers=1)
        with torch.device(dev):
            ace_m = fast_init(ACEStepModel(cfg), 7)
        ctx2 = torch.randn(2, 192, 768, generator=g)
        z0 = torch.randn(1, n, 8, generator=g)
        zs, vs = {}, {}
        for d in (dev, cpu):
            m = ace_m if d == dev else copy.deepcopy(ace_m).to(cpu)
            with torch.inference_mode():
                vs["card" if d is dev else "cpu"] = m.velocity(torch.cat([z0, z0]).to(d), torch.full((2,), 0.7,
                                                                             device=d),
                                        ctx2.to(d)).cpu()
            zs["card" if d is dev else "cpu"] = fm_sample(m, ctx2.to(d), n, steps=1, z_init=z0.to(d)).cpu()
        # bf16 products in another order, as the DiT's CPU parity test holds them
        rec["card_vs_cpu"]["dit_bf16_forward"] = card_vs_cpu(
            "in-repo DiT forward, 2 of 16 layers at 1024 wide", vs["card"], vs["cpu"],
            2e-2, tag=f"{tag} (e)", kind="bf16")
        rec["card_vs_cpu"]["acestep_step"] = card_vs_cpu(
            "one guided ACE-Step Euler step", zs["card"], zs["cpu"], 2e-2,
            tag=f"{tag} (e)", kind="bf16")
    rec["launches"] = path
    log(f"{tag} the path's launches (the cold calls of (a)-(c), the repaint and the served "
        f"calls of (d)): {path}")
    return rec


LORA_CLIP_S = 10.0           # the two training clips
LORA_STEPS = 6               # of LoRATrainConfig()'s 200
LORA_SSL_STEPS = 3           # the run with the SSL loss
LORA_ROUTE_STEPS = 4         # the served job's steps
LORA_GRAD_FRAMES = (32, 200)  # K1 (the default segment) and the 16-bit K2
CKPT_S = 30.0
CKPT_STEPS = 8               # of checkpoint_pcfg()'s 60
CKPT_CHECK_FRAMES = 64       # latent frames of the card-against-CPU checks
CLAP_S = 10.0


def lora_clip(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded chord of three harmonic tones with a little noise (float32)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(110.0, 440.0, 3))
    return (x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def plain_dit_attention(q, k, v, *args, **kw):
    """The DiT's self-attention by the plain version of the kernel
    ``flash_attention`` routes it to (K1 when every key fits one 128-key
    block, else K2), on any device: the yardstick of the LoRA gradients."""
    from audiolab_tpu_torch.kernels import attention as A

    scale = q.shape[-1] ** -0.5
    if k.shape[2] <= 128:
        return A.attention_nk1_reference(q, k, v, scale)
    return A.flash_attention_reference(q, k, v, False, scale)


def lora_loss(pipe, factors, t_frames: int, seed: int, plain: bool = False):
    """One LoRA training loss on ``pipe``'s DiT (batch 2, ``t_frames``
    frames, seeded latents, context and draws) with ``factors`` merged; with
    ``plain`` the self-attention runs by :func:`plain_dit_attention`."""
    import torch

    from audiolab_tpu_torch.models import dit as D
    from audiolab_tpu_torch.models.acestep import LoRAModel
    from audiolab_tpu_torch.train.acestep_lora import flow_match_loss

    dev = pipe.device
    g = torch.Generator().manual_seed(seed)
    c = pipe.cfg
    z0, eps = (torch.randn(2, t_frames, c.dcae.latent_dim, generator=g).to(dev) for _ in range(2))
    ctx = (0.5 * torch.randn(2, 192, c.text_dim, generator=g)).to(dev)
    t = torch.tensor([0.3, 0.8], device=dev)
    saved = D.flash_attention
    D.flash_attention = plain_dit_attention if plain else saved
    try:
        return flow_match_loss(LoRAModel(pipe.model, factors), z0, ctx, t, eps)
    finally:
        D.flash_attention = saved


def lora_factor_grads(pipe, t_frames: int, plain: bool = False):
    """(loss, {path: gradient of b}) of one :func:`lora_loss` from
    ``lora_init``'s factors (b = 0, so a gets none)."""
    import torch

    from audiolab_tpu_torch.models.acestep import lora_init

    factors = {p: {n: x.requires_grad_(True) for n, x in ab.items()}
               for p, ab in lora_init(pipe.model.dit, 8, seed=11).items()}
    loss = lora_loss(pipe, factors, t_frames, 12, plain)
    paths = sorted(factors)
    grads = torch.autograd.grad(loss, [factors[p]["b"] for p in paths])
    return float(loss), dict(zip(paths, grads))


def lora_step_trace(pipe, steps: int = 3) -> dict:
    """Device time of ``steps`` warm LoRA steps (:func:`lora_loss` and its
    backward at 32 frames) under torch.profiler: the total, the part under
    the attention Functions' backward nodes (the plain version's gradient)
    and under their forward (the kernel), and the five kernels that take
    most.  Device times are NaN where the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiolab_tpu_torch.models.acestep import lora_init

    factors = {p: {n: x.requires_grad_(True) for n, x in ab.items()}
               for p, ab in lora_init(pipe.model.dit, 8, seed=13).items()}

    def step():
        lora_loss(pipe, factors, LORA_GRAD_FRAMES[0], 14).backward()

    step()
    sync(pipe.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        sync(pipe.device)

    def dev_total(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))

    def dev_self(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = prof.events()
    total = sum(dev_self(e) for e in events) / 1e3 / steps
    bwd = sum(dev_total(e) for e in events if e.name.startswith(
        "autograd::engine::evaluate_function: _K") and "GradBackward" in e.name) / 1e3 / steps
    fwd = sum(dev_total(e) for e in events if e.name in ("_K1Grad", "_K2Grad")) / 1e3 / steps
    table = sorted(prof.key_averages(), key=dev_self, reverse=True)[:5]
    top = [(e.key[:60], dev_self(e) / 1e3 / steps) for e in table]
    if not total:
        total = bwd = fwd = float("nan")
    return dict(step_device_ms=total, attention_backward_ms=bwd, attention_forward_ms=fwd,
                top_kernels_ms=top)


def phase_lora(dev, card: str) -> dict:
    """ACE-Step's LoRA training, its routes, the checkpoint-layout model and
    CLAP on the card, weights by bench.py's rules (utils/fast_init.py):
    (a) ``train_lora`` at ACEStepConfig() (the DiT 1024 x 16 layers x 16
    heads, bf16) with LoRATrainConfig() (rank 8, batch 2, 32-frame
    segments) on two LORA_CLIP_S clips, cut to LORA_STEPS of 200 steps:
    the first and warm steps' seconds, peak memory and launches (K1 on its
    Hopper route, 16 a step: the backward launches none); then LORA_SSL_STEPS
    with the SSL loss on HuBERT's features (12 fp32 K2 a clip); (b) the b
    gradients of wq, wk and wv through the kernels' autograd.Function on
    the card against the plain version's (the DiT's attention replaced by
    the plain functions), at 32 frames (K1) and 200 frames (the 16-bit K2);
    (c) POST /api/v1/acestep/lora/train (polled to its end), lora/generate
    of LORA_SERVED_S with the adapter, and the base generate at the same seed
    before and after, which must be equal; (d) CheckpointACEStep at the
    JAX widths (ACEStepDiTConfig(): 1536 x 28 layers, fp32;
    LyricConformerEncoder(); UMT5-base through ACEStepTextEncoder; MusicDCAE
    on AutoencoderDC at DCAEConfig() and AdamosVocoder at AdamosConfig())
    on CKPT_S at CKPT_STEPS of checkpoint_pcfg()'s 60 steps, cold and warm,
    a guided step by CUDA events, no K1-K7 launch; (e) CLAP's branches at
    their defaults, card against CPU; (f) card against CPU at 2 layers: the
    checkpoint DiT's decode, the DCAE round trip, ADaMoS, one LoRA step's
    loss and factor gradients.  Returns the path's launches: (a)'s cold
    run, (b)'s kernel runs and (c)'s three calls."""
    import copy
    import tempfile
    import types

    import torch

    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.kernels.resample import resample
    from audiolab_tpu_torch.models.acestep import ACEStepConfig, ACEStepModel
    from audiolab_tpu_torch.models.acestep_dit import (
        ACEStepDiT,
        ACEStepDiTConfig,
        LyricConformerEncoder,
    )
    from audiolab_tpu_torch.models.adamos_vocoder import AdamosConfig, AdamosVocoder
    from audiolab_tpu_torch.models.clap import (
        ClapAudioBranch,
        ClapAudioConfig,
        ClapTextBranch,
        ClapTextConfig,
        clap_mel_image,
    )
    from audiolab_tpu_torch.models.codecs import VocosConfig
    from audiolab_tpu_torch.models.dcae import AutoencoderDC, DCAEConfig
    from audiolab_tpu_torch.models.dit import DiTConfig
    from audiolab_tpu_torch.models.hubert import HubertFeatureExtractor
    from audiolab_tpu_torch.models.music_dcae import MusicDCAE, dcae_codec_fns
    from audiolab_tpu_torch.models.t5 import T5Encoder, umt5_base
    from audiolab_tpu_torch.models.acestep import tokenize_lyrics
    from audiolab_tpu_torch.pipelines.acestep import (
        ACEStepTextEncoder,
        CheckpointACEStep,
        checkpoint_pcfg,
        random_acestep,
    )
    from audiolab_tpu_torch.serve import music_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.train.acestep_lora import LoRATrainConfig, train_lora
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    tag = "[lora]"
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_"))

    def add_path(launches):
        for k in KERNELS:
            path[k] += launches[k]

    def event_ms(fn) -> float:
        return cuda_ms(fn, iters=3) if cuda else float("nan")

    # (a) LoRA training at ACEStepConfig()
    t0 = time.perf_counter()
    pipe = random_acestep(ACEStepConfig(), vocos_cfg=VocosConfig(n_fft=2048, hop=512),
                          device=dev)
    sync(dev)
    n_layers, sr = pipe.cfg.dit.n_layers, pipe.cfg.sr
    log(f"{tag} (a) ACEStepPipeline at ACEStepConfig() built in {time.perf_counter() - t0:.1f} "
        f"s; cuts: {LORA_STEPS} of 200 steps, two {LORA_CLIP_S:g} s clips, random weights")
    dataset = [(lora_clip(LORA_CLIP_S, sr, i), MUSIC_PROMPT, MUSIC_LYRICS) for i in range(2)]

    def train(cfg, ssl_model=None):
        stamps = []

        def tick(*_):
            sync(dev)
            stamps.append(time.perf_counter())

        reset_counts()
        h0 = A.attention_nk1.sm90_launches
        _peak_reset(cuda)
        start = time.perf_counter()
        out = train_lora(pipe, dataset, cfg, callback=tick, ssl_model=ssl_model)
        sync(dev)
        return (out, stamps[0] - start, float(np.mean(np.diff(stamps))), counts(),
                A.attention_nk1.sm90_launches - h0, _peak_gb(cuda))

    cfg = LoRATrainConfig(steps=LORA_STEPS)
    out, first_s, warm_s, launches, sm90, peak = train(cfg)
    expect(np.isfinite(out["loss"]), f"(a) loss {out['loss']}")
    expect(all(float(ab["b"].abs().max()) > 0 for ab in out["lora"].values()),
           "(a) a factor b that training left at zero")
    if cuda:
        k1 = LORA_STEPS * n_layers
        expect(only(launches, "K1", k1), f"(a) launches {launches}, expected K1 {k1}")
        expect(sm90 == k1, f"(a) {sm90} of {k1} K1 on the Hopper route")
    add_path(launches)
    route = A.k1_route(2 * pipe.cfg.dit.n_heads, cfg.seg_latent, cfg.seg_latent,
                       pipe.cfg.dit.dim // pipe.cfg.dit.n_heads, torch.bfloat16)
    rec["train"] = dict(first_step_s=first_s, warm_step_s=warm_s, peak_gb=peak,
                        launches=launches, k1_per_step=launches["K1"] / LORA_STEPS,
                        k1_route=route, loss=out["loss"])
    log(f"{tag} (a) train_lora {LORA_STEPS} steps (rank {cfg.rank}, batch {cfg.batch_size}, "
        f"{cfg.seg_latent} frames): first step (with the clips' latents and contexts) "
        f"{first_s:.3f} s, warm step {warm_s:.4f} s, peak {peak:.2f} GB, launches {launches} "
        f"({launches['K1'] / LORA_STEPS:g} K1 a step, {sm90} on K1's Hopper {route} route; "
        f"the backward launches none), loss {out['loss']:.5f} | {card}")
    with torch.device(dev):
        hubert = fast_init(HubertFeatureExtractor("v2"), 9).eval()

    def ssl_model(audio):
        with torch.no_grad():
            x = torch.as_tensor(audio, dtype=torch.float32, device=dev)[None]
            return hubert(resample(x, sr, 16000))

    cfg_ssl = LoRATrainConfig(steps=LORA_SSL_STEPS, ssl_coeff=0.5, ssl_depth=1)
    out, first_s, warm_s, launches, sm90, peak = train(cfg_ssl, ssl_model)
    expect(np.isfinite(out["loss"]) and "proj" in out, f"(a) SSL loss {out['loss']}")
    if cuda:
        k1, k2 = LORA_SSL_STEPS * n_layers, 2 * hubert.cfg.layers
        expect(launches["K1"] == k1 and launches["K2"] == k2
               and all(launches[k] == 0 for k in KERNELS if k not in ("K1", "K2")),
               f"(a) SSL launches {launches}, expected K1 {k1}, K2 {k2}")
    rec["train_ssl"] = dict(first_step_s=first_s, warm_step_s=warm_s, peak_gb=peak,
                            launches=launches, loss=out["loss"])
    log(f"{tag} (a) with the SSL loss (coefficient {cfg_ssl.ssl_coeff}, block "
        f"{cfg_ssl.ssl_depth}, HuBERT v2 features): {LORA_SSL_STEPS} steps, first {first_s:.3f}"
        f" s, warm {warm_s:.4f} s, peak {peak:.2f} GB, launches {launches} (HuBERT's fp32 K2 "
        f"over each clip, then K1), loss {out['loss']:.5f} | {card}")
    del hubert
    tr = lora_step_trace(pipe)
    rec["trace"] = tr
    log(f"{tag} (a) trace of 3 warm LoRA steps (the loss at 32 frames and its backward, "
        f"torch.profiler): device time a step {tr['step_device_ms']:.3f} ms, of which the "
        f"attention's plain backward {tr['attention_backward_ms']:.3f} ms and its K1 forward "
        f"{tr['attention_forward_ms']:.3f} ms; top kernels "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top_kernels_ms"]) + f" | {card}")

    # (b) the gradient on the card against the plain version's
    rec["grads"] = {}
    for t_frames in LORA_GRAD_FRAMES:
        kern = "K1" if t_frames <= 128 else "K2"
        wrapper = A.attention_nk1 if kern == "K1" else A.flash_attention_fwd
        reset_counts()
        h0 = wrapper.sm90_launches
        loss_k, g_k = lora_factor_grads(pipe, t_frames)
        sync(dev)
        launches, sm90 = counts(), wrapper.sm90_launches - h0
        add_path(launches)
        loss_p, g_p = lora_factor_grads(pipe, t_frames, plain=True)
        errs = {}
        for target in ("wq", "wk", "wv", "wo"):
            ps = [p for p in g_k if p[-1] == target]
            gk = torch.stack([g_k[p] for p in ps]).float()
            gp = torch.stack([g_p[p] for p in ps]).float()
            scale = float(gp.abs().max())
            errs[target] = float((gk - gp).abs().max()) / scale
            expect(scale > 0 and float(gk.abs().max()) > 0,
                   f"(b) {t_frames} frames: no gradient reached b of {target}")
        if cuda:
            expect(only(launches, kern, n_layers) and sm90 == n_layers,
                   f"(b) {t_frames} frames: launches {launches} ({sm90} on the Hopper route), "
                   f"expected {kern} {n_layers}")
        expect(max(errs.values()) <= 2e-2 and abs(loss_k - loss_p) <= 2e-2 * abs(loss_p),
               f"(b) {t_frames} frames: b gradients {errs} from the plain version's "
               "(tolerance 2e-2)")
        rec["grads"][t_frames] = dict(kernel=kern, launches=launches, errs=errs,
                                      loss=loss_k, loss_plain=loss_p)
        log(f"{tag} (b) {t_frames} frames: the b gradients of wq/wk/wv/wo through {kern}'s "
            f"autograd.Function against the plain version's, max |diff| over max |g|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tolerance 2e-2, bf16 DiT); loss {loss_k:.6f} vs {loss_p:.6f}; launches "
            f"{launches} ({sm90} on {kern}'s Hopper route) | {card}")

    # (c) the two LoRA routes
    saved = dict(music_api._BACKENDS)
    server = None
    try:
        music_api._BACKENDS.clear()
        music_api.register_backend("acestep", pipe)
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        url = f"http://127.0.0.1:{port}/api/v1"
        clips = [dict(_wav_payload(work, f"clip{i}.wav", a[None], sr), prompt=p, lyrics=l)
                 for i, (a, p, l) in enumerate(dataset)]
        reset_counts()
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/acestep/lora/train", {
            "clips": clips, "settings": {"steps": LORA_ROUTE_STEPS, "rank": 8}})
        expect(status == 200, f"POST lora/train: HTTP {status} {resp}")
        while True:
            _s, info = http("GET", f"{url}/rvc/job/{resp['job_id']}")
            if info.get("status") != "running" or time.perf_counter() - t0 > 600:
                break
            time.sleep(0.2)
        train_s = time.perf_counter() - t0
        launches = counts()
        expect(info.get("status") == "done", f"lora/train job: {info}")
        if cuda:
            expect(only(launches, "K1", LORA_ROUTE_STEPS * n_layers),
                   f"lora/train: launches {launches}")
        add_path(launches)
        log(f"{tag} (c) POST /api/v1/acestep/lora/train ({LORA_ROUTE_STEPS} steps on two "
            f"{LORA_CLIP_S:g} s clips): done in {train_s:.3f} s, loss "
            f"{info['result']['loss']:.5f}, launches {launches} | {card}")
        body = {"prompt": MUSIC_PROMPT, "lyrics": MUSIC_LYRICS, "duration": MUSIC_SERVED_S,
                "seed": 5}
        answers = {}
        k1 = pipe.pcfg.steps * n_layers
        for label, b in (("base", body),
                         ("adapter", dict(body, lora_file_id=info["result"]["file_id"])),
                         ("base again", body)):
            reset_counts()
            t0 = time.perf_counter()
            status, r = http("POST", f"{url}/acestep/lora/generate", b)
            secs = time.perf_counter() - t0
            launches = counts()
            expect(status == 200, f"lora/generate ({label}): HTTP {status} {r}")
            a = _served_wav(work, r["audio"], "lora.wav")
            expect(a.samples.shape[-1] > 0 and np.isfinite(a.samples).all(), f"{label} WAV")
            if cuda:
                expect(only(launches, "K1", k1), f"lora/generate ({label}): {launches}")
            add_path(launches)
            answers[label] = r["audio"]
            log(f"{tag} (c) POST /api/v1/acestep/lora/generate ({label}, "
                f"{MUSIC_SERVED_S:g} s): HTTP {status} {secs:.3f} s, {a.samples.shape} at "
                f"{a.sample_rate} Hz, launches {launches} | {card}")
        expect(answers["base"] == answers["base again"],
               "(c) the base generate changed after an adapter request")
        expect(answers["adapter"] != answers["base"], "(c) the adapter changed nothing")
        rec["served"] = dict(train_s=train_s)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        music_api._BACKENDS.clear()
        music_api._BACKENDS.update(saved)
    del pipe
    torch.cuda.empty_cache() if cuda else None

    # (d) CheckpointACEStep at the JAX widths
    t0 = time.perf_counter()
    with torch.device(dev):
        dit = fast_init(ACEStepDiT(ACEStepDiTConfig()), 20)
        lyr = fast_init(LyricConformerEncoder(), 21)
        t5 = fast_init(T5Encoder(umt5_base()), 22)
        dcae = fast_init(AutoencoderDC(DCAEConfig()), 23).eval()
        voc = fast_init(AdamosVocoder(AdamosConfig()), 24).eval()
    enc = ACEStepTextEncoder(t5, music_spm_model(work / "umt5.model"), device=dev)
    pcfg = checkpoint_pcfg()
    pcfg.steps = CKPT_STEPS
    ck = CheckpointACEStep(dit, lyr, pcfg=pcfg, decode_fn=MusicDCAE(*dcae_codec_fns(dcae),
                                                                     voc).decode,
                           text_encoder=enc, device=dev)
    sync(dev)
    n_par = {name: sum(p.numel() for p in m.parameters()) / 1e6
             for name, m in (("DiT", dit), ("conformer", lyr), ("UMT5", t5), ("DCAE", dcae),
                             ("ADaMoS", voc))}
    log(f"{tag} (d) CheckpointACEStep built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} M" for k, v in n_par.items())
        + f" parameters, fp32; cut: {CKPT_STEPS} of 60 steps, random weights")
    hidden, mask = ck.text_embeddings([MUSIC_PROMPT])
    null = enc.null_embeddings([MUSIC_PROMPT])
    ids = tokenize_lyrics(MUSIC_LYRICS, 128)
    n_tok = int(np.count_nonzero(ids))
    ltoks = torch.from_numpy(ids[:n_tok].astype(np.int64))[None].to(dev)
    lmask = torch.ones_like(ltoks)
    speaker = torch.zeros(1, dit.cfg.speaker_embedding_dim, device=dev)
    secs = []
    for i in range(2):
        reset_counts()
        _peak_reset(cuda)
        t0 = time.perf_counter()
        y = ck.generate(hidden, mask, speaker, ltoks, lmask, duration=CKPT_S, seed=0,
                        text_hidden_null=null)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        launches, peak = counts(), _peak_gb(cuda)
        expect(all(v == 0 for v in launches.values()), f"(d) launches {launches}")
    frames = int(round(CKPT_S * ck.latent_rate))
    expect(y.shape == (1, 2, frames * 8 * 512) and np.isfinite(y).all(),
           f"(d) output {y.shape}, finite {np.isfinite(y).all()}")
    enc_c, m_c = ck.encode_cond(hidden, mask, speaker, ltoks, lmask)
    z = torch.randn(1, frames, 128, device=dev)
    tb = torch.full((1,), 500.0, device=dev)
    vel = ck._velocity(enc_c, m_c)
    with torch.inference_mode():
        step_ms = event_ms(lambda: (vel(z, tb), vel(z, tb)))
        lat = torch.randn(1, 8, 16, frames, device=dev)
        dec_ms = event_ms(lambda: ck.decode_fn(lat))
    rec["checkpoint"] = dict(cold_s=secs[0], warm_s=secs[1], peak_gb=peak, step_ms=step_ms,
                             decode_ms=dec_ms, launches=launches)
    log(f"{tag} (d) generate {CKPT_S:g} s ({frames} latent frames), {CKPT_STEPS} Euler steps "
        f"shift 3, guidance on the middle half, ERG: cold {secs[0]:.3f} s, warm {secs[1]:.3f} s,"
        f" peak {peak:.2f} GB; a guided step (cond + uncond forwards) {step_ms:.2f} ms, "
        f"MusicDCAE.decode {dec_ms:.2f} ms; launches {launches} (none expected: linear "
        f"self-attention, plain cross-attention) | {card}")
    del ck, enc, t5, lyr, y, z, lat, vel
    torch.cuda.empty_cache() if cuda else None

    # (f) card against CPU at 2 layers (and the full-width codec)
    rec["card_vs_cpu"] = {}
    if cuda:
        g = torch.Generator().manual_seed(31)
        n = CKPT_CHECK_FRAMES
        with torch.device(dev):
            dit2 = fast_init(ACEStepDiT(ACEStepDiTConfig(num_layers=2)), 25)
        c = dit2.cfg
        args = (torch.randn(1, 8, 16, n, generator=g), torch.ones(1, n),
                0.5 * torch.randn(1, 24, 768, generator=g), torch.ones(1, 24, dtype=torch.long),
                torch.randn(1, c.speaker_embedding_dim, generator=g), torch.tensor([400.0]),
                torch.randn(1, 20, c.lyric_hidden_size, generator=g),
                torch.ones(1, 20, dtype=torch.long))
        outs = {}
        for d in (dev, cpu):
            m = dit2 if d == dev else copy.deepcopy(dit2).to(cpu)
            with torch.inference_mode():
                outs[d.type] = m(*(x.to(d) for x in args), return_hidden=False).cpu()
        rec["card_vs_cpu"]["dit_decode"] = card_vs_cpu(
            "checkpoint DiT decode, 2 of 28 layers at full width", outs["cuda"], outs["cpu"],
            1e-4, tag=f"{tag} (f)")
        mel = torch.randn(1, 2, 128, n, generator=g)
        mel_v = torch.randn(1, 32, 128, generator=g)
        for name, mod, fn, x in (("DCAE round trip at DCAEConfig()", dcae,
                                  lambda m, x: m.decode(m.encode(x)), mel),
                                 ("ADaMoS at AdamosConfig()", voc, lambda m, x: m(x), mel_v)):
            o = {}
            for d in (dev, cpu):
                m = mod if d == dev else copy.deepcopy(mod).to(cpu)
                with torch.inference_mode():
                    o[d.type] = fn(m, x.to(d)).cpu()
            rec["card_vs_cpu"][name] = card_vs_cpu(name, o["cuda"], o["cpu"], 1e-4,
                                                   tag=f"{tag} (f)")
        lcfg = ACEStepConfig(dit=DiTConfig(dim=1024, n_layers=2, n_heads=16, cond_dim=768,
                                           in_dim=8, out_dim=8), text_layers=1)
        with torch.device(dev):
            small = fast_init(ACEStepModel(lcfg), 26)
        res = {}
        for d in (dev, cpu):
            p = types.SimpleNamespace(device=d, cfg=lcfg,
                                      model=small if d == dev else copy.deepcopy(small).to(cpu))
            res[d.type] = lora_factor_grads(p, LORA_GRAD_FRAMES[0])
        for target in ("wq", "wk", "wv", "wo"):
            ps = sorted(p for p in res["cpu"][1] if p[-1] == target)
            rec["card_vs_cpu"][f"lora_grad_{target}"] = card_vs_cpu(
                f"one LoRA step's gradient of b of {target} (bf16 DiT, 2 layers)",
                torch.stack([res["cuda"][1][p] for p in ps]).float().cpu(),
                torch.stack([res["cpu"][1][p] for p in ps]).float(), 2e-2, tag=f"{tag} (f)",
                kind="bf16")
        rec["card_vs_cpu"]["lora_loss"] = card_vs_cpu(
            "one LoRA step's loss", np.array([res["cuda"][0]]), np.array([res["cpu"][0]]),
            2e-2, tag=f"{tag} (f)", kind="bf16")
        del dit2, small
    del dcae, voc, dit
    torch.cuda.empty_cache() if cuda else None

    # (e) CLAP's two branches at their defaults, on the card only
    if not cuda:
        rec["launches"] = path
        return rec
    with torch.device(dev):
        text_b = fast_init(ClapTextBranch(ClapTextConfig()), 27).eval()
        audio_b = fast_init(ClapAudioBranch(ClapAudioConfig()), 28).eval()
    g = torch.Generator().manual_seed(32)
    ids = torch.randint(3, ClapTextConfig().vocab_size, (2, 32), generator=g)
    ids[:, 0] = 0
    ids[1, 20:] = ClapTextConfig().pad_id
    amask = (ids != ClapTextConfig().pad_id).long()
    wav = torch.from_numpy(lora_clip(CLAP_S, 48000, 7))[None]
    img = clap_mel_image(wav.to(dev))
    for name, mod, x in (("text branch", text_b, (ids, amask)), ("audio branch", audio_b, (img,))):
        o = {}
        for d in (dev, cpu):
            m = mod if d == dev else copy.deepcopy(mod).to(cpu)
            with torch.inference_mode():
                o[d.type] = m(*(a.to(d) for a in x)).cpu()
        with torch.inference_mode():
            ms = event_ms(lambda: mod(*(a.to(dev) for a in x)))
        expect(o["cuda"].shape == (x[0].shape[0], 512), f"(e) CLAP {name} {o['cuda'].shape}")
        rec[f"clap_{name}"] = dict(ms=ms, err=card_vs_cpu(
            f"CLAP {name} at its defaults ({ms:.2f} ms on the card)", o["cuda"], o["cpu"],
            1e-4, tag=f"{tag} (e)"))
    del text_b, audio_b
    torch.cuda.empty_cache() if cuda else None
    rec["launches"] = path
    log(f"{tag} the path's launches ((a)'s first run, (b)'s kernel runs and (c)'s calls): "
        f"{path}")
    return rec


YUE_GENRE = "inspiring female uplifting pop airy vocal electronic bright vocal"
YUE_LYRICS = ("[verse]\nwalking through the night with the city lights\n"
              "every step a heartbeat in the quiet streets\n\n"
              "[chorus]\nwe are the light, we are the fire\nhold on tight and take me higher")
YUE_FRAMES = 512             # one segment, 10.24 s at 50 frames a second
YUE_EAGER_FRAMES = 32        # stage 1's eager steps against the captured ones
YUE_SERVED_S = 2.0           # the served request's segment
YUE_CKPT_S = 1.0             # the checkpoint path's segment


def yue_draws(seed: int, shape: tuple):
    """Stage-1 Gumbel draws made on the CPU from ``seed``: the same numbers
    for the card's and the CPU's pipelines."""
    import torch

    from audiolab_tpu_torch.models.lm import gumbel_draws

    return gumbel_draws(*shape, seed, torch.device("cpu"))


def write_safetensors(path: Path, sd: dict) -> int:
    """``sd`` in the safetensors layout (an 8-byte little-endian header
    length, the JSON header of dtypes, shapes and offsets, the raw bytes),
    written here: the card's machine has no safetensors package.  Returns
    the file's bytes."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.int64: "I64"}
    header, blobs, off = {}, [], 0
    for k, v in sd.items():
        v = v.detach().contiguous().cpu()
        raw = v.reshape(-1).view(torch.uint8).numpy().tobytes() if v.numel() else b""
        header[k] = {"dtype": names[v.dtype], "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return 8 + len(head) + off


def write_yue_stack(root: Path, s1, s2, xdec, shards: int = 2) -> dict:
    """YuE's published layout for the port modules ``s1``, ``s2`` and
    ``xdec``: per stage a directory with config.json and bf16 safetensors in
    ``shards`` files with model.safetensors.index.json, the xcodec decoder
    as final.pth ({"codec_model": ...}, ``model.`` prefixes, each
    convolution as a weight-norm pair), and a tokenizer.model with the mm
    control pieces.  Returns the paths and the bytes written."""
    import torch

    from audiolab_tpu_torch.models.mm_vocab import MM_SPECIAL_TOKENS
    from audiolab_tpu_torch.utils.spm import UNIGRAM, build_model_proto

    out, total = {}, 0
    for stage, lm in (("stage1", s1), ("stage2", s2)):
        c, d = lm.cfg, root / stage
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(dict(
            architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=c.vocab_size,
            hidden_size=c.dim, intermediate_size=c.ffn_dim, num_hidden_layers=c.n_layers,
            num_attention_heads=c.n_heads, num_key_value_heads=c.n_kv_heads,
            max_position_embeddings=c.max_seq_len, rms_norm_eps=c.norm_eps,
            rope_theta=c.rope_theta, tie_word_embeddings=False, torch_dtype="bfloat16")))
        sd = {k: v.bfloat16() for k, v in lm.state_dict().items()}
        keys = sorted(sd)
        per = -(-len(keys) // shards)
        weight_map = {}
        for si in range(shards):
            name = f"model-{si + 1:05d}-of-{shards:05d}.safetensors"
            part = keys[si * per:(si + 1) * per]
            total += write_safetensors(d / name, {k: sd[k] for k in part})
            weight_map.update(dict.fromkeys(part, name))
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}))
        out[stage] = str(d)
    xsd = {}
    for k, v in xdec.state_dict().items():
        v = v.detach().cpu()
        if k.endswith(".weight") and v.dim() == 3:
            xsd[f"model.{k[:-6]}weight_g"] = v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
            xsd[f"model.{k[:-6]}weight_v"] = 2.0 * v
        else:
            xsd[f"model.{k}"] = v
    out["xcodec"] = str(root / "final.pth")
    torch.save({"codec_model": xsd}, out["xcodec"])
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -2.0, 1)]
              + [(f"▁{w}", -3.0, 1) for w in sorted(set(YUE_LYRICS.split()))]
              + [(ch, -8.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz[]_.,\n"]
              + [(tok, 0.0, 3) for tok in MM_SPECIAL_TOKENS])
    out["tokenizer"] = str(root / "tokenizer.model")
    Path(out["tokenizer"]).write_bytes(build_model_proto(pieces, model_type=UNIGRAM))
    out["bytes"] = total + Path(out["xcodec"]).stat().st_size
    return out


def phase_yue(dev, card: str, profile_dir: str | None = None) -> dict:
    """YuE on the card: (a) random_yue (2 + 2 layers, fp32) with its decode
    steps captured against a CPU copy under the same draws: identical codes,
    the audio within 1e-5 of max|y|; XCodecConfig()'s decoder on 50 frames,
    card against CPU; (b) YuEConfig() (stage 1 2048 x 16 layers, bf16;
    stage 2 1024 x 8), YuEVocab() (83,734 ids) and XCodecConfig(), weights
    by bench.py's rules (utils/fast_init.py), on one YUE_FRAMES-frame
    segment at the published sampling (CFG 1.5, top-p 0.93, repetition
    penalty 1.2): stage 1's prefill seconds and captured steps/s against
    YUE_EAGER_FRAMES eager frames (identical codes under the same draws),
    stage 2's block count and steps/s, the xcodec decode's seconds, the
    whole generate_music cold and warm with its peak memory and launches
    (none of K1-K7: both stages prefill through the static cache, where
    the attention is the plain version); (c) POST /api/v1/yue/generate on
    YUE_SERVED_S and GET /api/v1/yue/stream/{file_id}; (d) a 2-layer stack at
    the published widths written in the upstream layout (sharded bf16
    safetensors with their index and config.json per stage, an xcodec .pth
    with weight-norm pairs, a tokenizer.model), loaded by load_yue_pipeline
    onto the card: the same weights and codes as the pipeline of the
    modules it was written from.  ``profile_dir``: (b)'s warm call once more
    under torch.profiler, its device time by kernel.  Returns the path's
    launches: (b)'s cold call and (c)'s request."""
    import base64
    import copy
    import dataclasses
    import tempfile

    import torch

    from audiolab_tpu_torch.models.codecs import XCodecConfig, XCodecDecoder
    from audiolab_tpu_torch.models.lm import TransformerLM
    from audiolab_tpu_torch.models.mm_vocab import MMTokenizer
    from audiolab_tpu_torch.models.yue import (
        YuEConfig,
        YuEPipeline,
        random_yue,
        stage1_generate,
    )
    from audiolab_tpu_torch.serve import music_api
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background
    from audiolab_tpu_torch.utils.convert import load_yue_pipeline
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    tag = "[yue]"
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_yue_"))

    def add_path(launches):
        for k in KERNELS:
            path[k] += launches[k]

    # (a) card against CPU
    small = random_yue(seed=4, device=dev)
    small.draws = yue_draws
    host = copy.copy(small)
    for name in ("s1", "s2", "codec"):
        setattr(host, name, copy.deepcopy(getattr(small, name)).to(cpu))
    host.device = cpu
    res = {}
    for label, pipe in (("card", small), ("cpu", host)):
        stats: dict = {}
        out = pipe.generate_music("pop", "la la la\n\nna na na", n_segments=2, seed=3,
                                  stats=stats)
        res[label] = (stats["codes"], out)
    expect(torch.equal(res["card"][0], res["cpu"][0]),
           "(a) random_yue's codes on the card differ from the CPU's")
    rec["card_vs_cpu"] = {k: card_vs_cpu(f"random_yue {k}", res["card"][1][k],
                                         res["cpu"][1][k], 1e-5, tag=f"{tag} (a)")
                          for k in ("vocal", "inst", "mix")}
    log(f"{tag} (a) random_yue (2 + 2 layers of 32, fp32, two 16-frame segments) with captured "
        f"steps on the card and eager on the CPU under the same draws: codes identical "
        f"{tuple(res['cpu'][0].shape)}")
    del small, host
    with torch.device(dev):
        xdec = fast_init(XCodecDecoder(XCodecConfig()), 42).eval()
    codes = torch.from_numpy(np.random.default_rng(6).integers(0, 1024, (2, 8, 50)))
    with torch.inference_mode():
        got = xdec(codes.to(dev)).cpu()
        want = copy.deepcopy(xdec).to(cpu)(codes)
    rec["card_vs_cpu"]["xcodec"] = card_vs_cpu(
        "XCodecDecoder at XCodecConfig() on 50 frames", got, want, 1e-5, tag=f"{tag} (a)")

    # (b) full width
    cfg = YuEConfig()
    t0 = time.perf_counter()
    with torch.device(dev):
        s1 = fast_init(TransformerLM(cfg.stage1), 40).eval()
        s2 = fast_init(TransformerLM(cfg.stage2), 41).eval()
    pipe = YuEPipeline(cfg, s1, s2, xcodec=xdec, device=dev)
    pipe.pcfg.segment_frames = YUE_FRAMES
    sync(dev)
    n_par = {k: sum(p.numel() for p in m.parameters()) / 1e6
             for k, m in (("stage 1", s1), ("stage 2", s2), ("xcodec", xdec))}
    log(f"{tag} (b) YuEConfig() built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} M" for k, v in n_par.items())
        + f" parameters (stage 1 {cfg.stage1.dtype}, lm_head fp32); vocabulary "
        f"{cfg.vocab.size}; cut: one {YUE_FRAMES}-frame segment, random weights")
    prompt, vf = pipe._prompt(YUE_GENRE, YUE_LYRICS.split("\n\n")[0], full_lyrics=YUE_LYRICS)
    runs = {}
    for label, graph in (("graph", cuda), ("eager", False)):
        stats = {}
        runs[label] = stage1_generate(
            s1, prompt, YUE_EAGER_FRAMES, cfg.vocab, valid_from=vf, seed=7, graph=graph,
            stats=stats, device=dev)
        runs[label + "_stats"] = stats
    expect(torch.equal(runs["graph"], runs["eager"]),
           "(b) stage 1's captured steps give other codes than the eager steps")
    eager_sps = runs["eager_stats"]["steps"] / runs["eager_stats"]["decode_s"]
    secs, stats_all = [], []
    for i in range(2):
        stats = {}
        reset_counts()
        _peak_reset(cuda)
        t0 = time.perf_counter()
        out = pipe.generate_music(YUE_GENRE, YUE_LYRICS, n_segments=1, seed=0, stats=stats)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        launches, peak = counts(), _peak_gb(cuda)
        stats_all.append(stats)
        expect(all(v == 0 for v in launches.values()), f"(b) launches {launches}")
        if i == 0:
            add_path(launches)
    expect(out["sr"] == 16000 and out["mix"].shape == (YUE_FRAMES * 320,)
           and np.isfinite(out["mix"]).all() and np.abs(out["mix"]).max() <= 0.99 + 1e-6,
           f"(b) output {out['mix'].shape} at {out['sr']} Hz")
    full = stats["codes"]
    expect(full.shape == (2, cfg.n_q, YUE_FRAMES) and int(full.min()) >= 0
           and int(full.max()) < 1024, f"(b) codes {tuple(full.shape)}")
    st1, st2 = stats["stage1"][0], stats["stage2"]
    cold1 = stats_all[0]["stage1"][0]
    rec["full"] = dict(cold_s=secs[0], warm_s=secs[1], peak_gb=peak, launches=launches,
                       s1_prefill_s=st1["prefill_s"], s1_steps=st1["steps"],
                       s1_steps_per_s=st1["steps"] / st1["decode_s"],
                       s1_cold_steps_per_s=cold1["steps"] / cold1["decode_s"],
                       s1_eager_steps_per_s=eager_sps,
                       s2_blocks=st2["blocks"], s2_bucket=st2["blocks_bucket"],
                       s2_prefill_s=st2["prefill_s"], s2_steps=st2["steps"],
                       s2_steps_per_s=st2["steps"] / st2["decode_s"],
                       xcodec_s=stats["decode_s"], audio_s=len(out["mix"]) / out["sr"])
    r = rec["full"]
    log(f"{tag} (b) generate_music, one {YUE_FRAMES}-frame segment ({r['audio_s']:g} s at "
        f"16 kHz): cold {secs[0]:.3f} s, warm {secs[1]:.3f} s, peak {peak:.2f} GB, launches "
        f"{launches} | {card}")
    log(f"{tag} (b) stage 1 (prompt {prompt.shape[1]} tokens, bucket "
        f"{-(-prompt.shape[1] // 128) * 128}): prefill {st1['prefill_s']:.4f} s, "
        f"{st1['steps']} captured steps at {r['s1_steps_per_s']:.1f} steps/s "
        f"({1e3 / r['s1_steps_per_s']:.3f} ms a step; cold call {r['s1_cold_steps_per_s']:.1f})"
        f"; eager {eager_sps:.1f} steps/s over {2 * YUE_EAGER_FRAMES} steps, codes identical to "
        f"the captured ones | {card}")
    log(f"{tag} (b) stage 2: {st2['blocks']} blocks of {cfg.stage2_block} (bucket "
        f"{st2['blocks_bucket']}), prefill {st2['prefill_s']:.4f} s, {st2['steps']} captured "
        f"steps at {r['s2_steps_per_s']:.1f} steps/s ({1e3 / r['s2_steps_per_s']:.3f} ms a "
        f"step); xcodec decode {stats['decode_s']:.4f} s | {card}")
    if profile_dir and cuda:
        rec["profile"] = profile_call(
            "YuE generate_music warm", lambda: pipe.generate_music(
                YUE_GENRE, YUE_LYRICS, n_segments=1, seed=0),
            {"stage 1": st1["prefill_s"] + st1["decode_s"],
             "stage 2": st2["prefill_s"] + st2["decode_s"], "xcodec": stats["decode_s"]},
            dev, profile_dir, card, tag=tag)

    # (c) the served request
    saved = dict(music_api._BACKENDS)
    server = None
    try:
        music_api._BACKENDS.clear()
        music_api.register_backend("yue", pipe)
        server, port = serve_background(create_app(str(work / "process"), device=dev))
        url = f"http://127.0.0.1:{port}/api/v1"
        reset_counts()
        t0 = time.perf_counter()
        status, resp = http("POST", f"{url}/yue/generate", {
            "prompt": YUE_GENRE, "lyrics": YUE_LYRICS,
            "settings": {"seconds_per_segment": YUE_SERVED_S, "seed": 2}})
        served_s = time.perf_counter() - t0
        launches = counts()
        expect(status == 200, f"POST yue/generate: HTTP {status} {resp}")
        a = _served_wav(work, resp["audio"], "yue.wav")
        n_smp = int(YUE_SERVED_S * 50) * 320
        expect(a.sample_rate == 16000 and a.samples.shape[-1] == n_smp
               and np.isfinite(a.samples).all(), f"yue WAV {a.samples.shape} {a.sample_rate}")
        expect(all(v == 0 for v in launches.values()), f"(c) launches {launches}")
        add_path(launches)
        raw = urllib_get(f"{url}/yue/stream/{resp['file_id']}")
        expect(raw == base64.b64decode(resp["audio"]), "(c) yue/stream gives another file")
        rec["served"] = dict(seconds=served_s, launches=launches)
        log(f"{tag} (c) POST /api/v1/yue/generate ({YUE_SERVED_S:g} s): HTTP {status} "
            f"{served_s:.3f} s, {a.samples.shape} at {a.sample_rate} Hz, launches {launches}; "
            f"GET /api/v1/yue/stream/{{file_id}}: the same {len(raw)} bytes | {card}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        music_api._BACKENDS.clear()
        music_api._BACKENDS.update(saved)
    del pipe, s1, s2
    torch.cuda.empty_cache() if cuda else None

    # (d) the checkpoint path: a 2-layer stack at the published widths
    c2 = YuEConfig(stage1=dataclasses.replace(cfg.stage1, n_layers=2),
                   stage2=dataclasses.replace(cfg.stage2, n_layers=2))
    with torch.device(dev):
        s1 = fast_init(TransformerLM(c2.stage1), 50).eval()
        s2 = fast_init(TransformerLM(c2.stage2), 51).eval()
    with torch.no_grad():
        for lm in (s1, s2):       # the published files are bf16: so are these numbers
            for prm in lm.parameters():
                prm.copy_(prm.bfloat16())
    t0 = time.perf_counter()
    files = write_yue_stack(work / "stack", s1, s2, xdec)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_yue_pipeline(files["stage1"], files["stage2"], files["xcodec"],
                               tokenizer_model=files["tokenizer"], device=dev)
    sync(dev)
    load_s = time.perf_counter() - t0
    expect(vars(loaded.cfg.stage1) == vars(c2.stage1) and vars(loaded.cfg.stage2) == vars(
        c2.stage2), f"(d) configs {loaded.cfg.stage1} {loaded.cfg.stage2}")
    for name, lm in (("s1", s1), ("s2", s2)):
        mine = lm.state_dict()
        expect(all(torch.equal(v, mine[k]) for k, v in getattr(loaded, name).state_dict().items()),
               f"(d) {name}'s loaded weights differ from the written ones")
    ref = YuEPipeline(c2, s1, s2, xcodec=xdec, tokenizer=MMTokenizer(
        model_file=files["tokenizer"]), device=dev)
    outs = {}
    for label, p in (("in memory", ref), ("loaded", loaded)):
        p.draws = yue_draws
        stats = {}
        outs[label] = (p.generate_music(YUE_GENRE, YUE_LYRICS, seconds_per_segment=YUE_CKPT_S,
                                        seed=1, stats=stats), stats["codes"])
    expect(torch.equal(outs["loaded"][1], outs["in memory"][1]),
           "(d) the loaded stack's codes differ from the in-memory pipeline's")
    a, b = outs["loaded"][0]["mix"], outs["in memory"][0]["mix"]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    expect(a.shape == b.shape and np.isfinite(a).all() and err <= 1e-5,
           f"(d) the loaded stack's mix {err:.3e} of max|y| from the in-memory pipeline's")
    rec["checkpoint"] = dict(write_s=write_s, load_s=load_s, bytes=files["bytes"], mix_err=err)
    log(f"{tag} (d) load_yue_pipeline of a 2 + 2-layer stack at the published widths "
        f"({files['bytes'] / 1e9:.2f} GB: sharded bf16 safetensors with their index, the "
        f"xcodec .pth with weight-norm pairs, tokenizer.model) written in {write_s:.2f} s, "
        f"loaded onto the card in {load_s:.2f} s: weights equal, codes "
        f"{tuple(outs['loaded'][1].shape)} identical to the in-memory pipeline's, the mix "
        f"{err:.3e} of max|y| from it (tolerance 1e-5: the weight-norm fold rounds) | {card}")
    del loaded, ref, s1, s2, xdec
    torch.cuda.empty_cache() if cuda else None
    rec["launches"] = path
    log(f"{tag} the path's launches ((b)'s cold call and (c)'s request): {path}")
    return rec


def urllib_get(url: str, timeout: float = 60.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


# ---------------------------------------------------------------- loaders

# upstream's weight-normed convolutions: RVC's WaveNet layers, decoder
# upsamplers, resblocks and conv_post; fairseq HuBERT's positional conv
RVC_WN = re.compile(r"^(flow\.flows\.\d+\.enc|enc_q\.enc)\.(in_layers\.\d+|res_skip_layers\.\d+"
                    r"|cond_layer)\.weight$|^dec\.(conv_post|ups\.\d+|resblocks\.\d+\.convs[12]"
                    r"\.\d+)\.weight$")
HUBERT_WN = re.compile(r"^encoder\.pos_conv\.0\.weight$")
# the wav2vec2 aligner's positional conv (HF's pos_conv_embed.conv) and every
# convolution of AudioSR's vocoder
W2V_WN = re.compile(r"^encoder\.encoder\.pos_conv\.0\.weight$")
AUDIOSR_VOCODER_WN = re.compile(r"^(conv_pre|conv_post|ups\.\d+|resblocks\.\d+\.convs[12]\.\d+)"
                                r"\.weight$")
# descript-audio-codec's decoder: every convolution, transposed convolution
# and quantizer out_proj; XTTS-v2's HiFi decoder: the up-convolutions and the
# residual blocks' convolutions (conv_pre and conv_post carry none)
DAC_WN = re.compile(r"^(decoder\.model\.\d+(\.block\.\d+(\.block\.\d+)?)?"
                    r"|quantizer\.quantizers\.\d+\.out_proj)\.weight$")
XTTS_HIFI_WN = re.compile(r"^(ups\.\d+|resblocks\.\d+\.convs[12]\.\d+)\.weight$")
MDX23C_SCALES = re.compile(r"^((?:encoder_blocks\.\d+\.downscale)|(?:decoder_blocks\.\d+"
                           r"\.upscale))\.(\d+\.)")


def cpu_state(module) -> dict:
    """A copy of ``module``'s state_dict on the host (never its own tensors)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def weight_norm_pairs(sd: dict, pattern, dim: int = 0) -> dict:
    """``sd`` with each ``.weight`` whose key ``pattern`` matches split into
    upstream's weight-norm pair: ``weight_g`` its norm over every axis but
    ``dim`` (summed in fp32, stored in the weight's type), ``weight_v`` the
    weight itself."""
    out = {}
    for k, v in sd.items():
        if pattern.match(k):
            axes = [i for i in range(v.dim()) if i != dim]
            out[k[:-6] + "weight_g"] = v.float().pow(2).sum(axes, keepdim=True).sqrt().to(v.dtype)
            out[k[:-6] + "weight_v"] = v
        else:
            out[k] = v
    return out


def rvc_process_ckpt(sd: dict, cfg, sr_tag: str = "48k", version: str = "v2",
                     f0: int = 1) -> dict:
    """A voice as upstream's process_ckpt saves it: ``weight`` the fp16
    state_dict with weight-norm pairs, ``config`` the hparams list, the
    ``sr`` tag, ``f0`` and ``version``."""
    weight = weight_norm_pairs({k: v.detach().cpu().half() for k, v in sd.items()}, RVC_WN)
    config = [cfg.spec_channels, cfg.segment_size // (cfg.sr // 100), cfg.inter_channels,
              cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, cfg.n_layers,
              cfg.kernel_size, 0, "1", list(cfg.resblock_kernel_sizes),
              [list(d) for d in cfg.resblock_dilation_sizes], list(cfg.upsample_rates),
              cfg.upsample_initial_channel, list(cfg.upsample_kernel_sizes), cfg.spk_embed_dim,
              cfg.gin_channels, cfg.sr]
    return {"weight": weight, "config": config, "info": "0epoch", "sr": sr_tag, "f0": f0,
            "version": version}


def mdx23c_upstream_names(sd: dict) -> dict:
    """The port's MDX23C state_dict under ZFTurbo's tfc_tdf_v3 names, whose
    down/upscale Sequential sits under ``.conv``."""
    return {MDX23C_SCALES.sub(r"\1.conv.\2", k): v for k, v in sd.items()}


def gains_off(sd: dict, seed: int) -> dict:
    """``sd`` with every weight-norm gain (``weight_g``) moved off its
    weight's norm by a factor in [1, 1.2) drawn from ``seed``, so that a fold
    over the wrong dim gives other weights."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return {k: v * (1.0 + 0.2 * torch.rand(v.shape, generator=g)).to(v.dtype)
            if k.endswith("weight_g") else v for k, v in sd.items()}


def dac_encoder_state(seed: int, n_q: int = 9, latent: int = 1024, codebook_dim: int = 8) -> dict:
    """descript-audio-codec's 44.1 kHz encoder (d_model 64, strides 2, 4, 8,
    8) and each quantizer's ``in_proj`` under their names, every convolution
    a weight-norm pair, seeded values: what ``weights.pth`` holds beside the
    decode path."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd: dict = {}

    def wn(key, cout, cin, k):
        sd[f"{key}.weight_g"] = torch.rand(cout, 1, 1, generator=g)
        sd[f"{key}.weight_v"] = 0.05 * torch.randn(cout, cin, k, generator=g)
        sd[f"{key}.bias"] = 0.01 * torch.randn(cout, generator=g)

    def snake(key, ch):
        sd[f"{key}.alpha"] = torch.rand(1, ch, 1, generator=g)

    wn("encoder.block.0", 64, 1, 7)
    d = 64
    for i, stride in enumerate((2, 4, 8, 8)):
        blk = f"encoder.block.{1 + i}.block"
        for j in range(3):
            snake(f"{blk}.{j}.block.0", d)
            wn(f"{blk}.{j}.block.1", d, d, 7)
            snake(f"{blk}.{j}.block.2", d)
            wn(f"{blk}.{j}.block.3", d, d, 1)
        snake(f"{blk}.3", d)
        wn(f"{blk}.4", 2 * d, d, 2 * stride)
        d *= 2
    snake("encoder.block.5", d)
    wn("encoder.block.6", latent, d, 3)
    for i in range(n_q):
        wn(f"quantizer.quantizers.{i}.in_proj", codebook_dim, latent, 1)
    return sd


def off_their_init(module, seed: int):
    """``module`` in place with every batch norm's gain and bias (where it has
    an affine) and running statistics and every GRU / LSTM bias drawn from
    ``seed`` (fast_init
    leaves them at 1, 0, 0, 1 and 0, where a loader's fold of them is the
    identity or cannot tell a sum from a copy)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def draw(shape, scale, shift=0.0, uniform=False):
        r = (torch.rand if uniform else torch.randn)(shape, generator=g, device="cpu")
        return shift + scale * r

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                if m.affine:
                    m.weight.copy_(draw(c, 0.2, 1.0))
                    m.bias.copy_(draw(c, 0.1))
                m.running_mean.copy_(draw(c, 0.1))
                m.running_var.copy_(draw(c, 1.0, 0.5, uniform=True))
            elif isinstance(m, (torch.nn.GRU, torch.nn.LSTM)):
                for name, b in m.named_parameters():
                    if name.startswith("bias"):
                        b.copy_(draw(b.shape, 0.1))
    return module


def tensors_against(dev, tag: str, label: str, own: dict, mine: dict) -> tuple[list, list]:
    """The keys whose loaded tensor (``own``) differs from its twin's
    (``mine``), and those whose loaded tensor is off ``dev``; fails if the
    two hold other keys."""
    import torch

    expect(set(own) == set(mine), f"{tag} {label}: keys differ: "
                                  f"{sorted(set(own) ^ set(mine))[:8]}")
    unequal = [k for k in mine if not torch.equal(own[k], mine[k].to(own[k].device))]
    return unequal, [k for k in own if own[k].device.type != dev.type]


def load_through_file(dev, work: Path, files: dict, card: str, label: str, name: str, obj, load,
                      module, write=None, state_of=None, tag: str = "[loaders]"):
    """Write ``obj`` to ``work / name`` (``torch.save``, or ``write(path,
    obj)``), load it with ``load(path)``, and hold the loaded tensors
    (``state_of(loaded)``, by default the state_dict of the loaded module or
    of a tuple's first) against ``module``'s (a module or a state_dict): the
    same keys, every tensor equal and on the card.  Records the file's
    bytes, write and load seconds in ``files[label]`` and deletes the file
    (one on the disk at a time).  Returns what ``load`` returned."""
    import torch

    path = work / name
    t0 = time.perf_counter()
    if write is None:
        torch.save(obj, path)
    else:
        write(path, obj)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = load(str(path))
    sync(dev)
    load_s = time.perf_counter() - t0
    size = path.stat().st_size
    path.unlink()
    if state_of is None:
        own = (got[0] if isinstance(got, tuple) else got).state_dict()
    else:
        own = state_of(got)
    mine = module.state_dict() if isinstance(module, torch.nn.Module) else module
    unequal, off = tensors_against(dev, tag, label, own, mine)
    files[label] = dict(bytes=size, write_s=write_s, load_s=load_s, tensors=len(own))
    log(f"{tag} {label}: {name} {size / 2**20:.1f} MiB, written in "
        f"{write_s:.3f} s, loaded onto {dev.type} in {load_s:.3f} s; {len(own)} tensors, "
        f"{len(unequal)} unequal, {len(off)} off {dev.type} | {card}")
    expect(not unequal, f"{tag} {label}: tensors differ from the module's: {unequal[:8]}")
    expect(not off, f"{tag} {label}: tensors off {dev.type}: {off[:8]}")
    return got


LOADERS_CLIP_S = 10.0     # the clip HTDemucs, MDX23C and the VR nets separate from their files
FOLD_TOL = 1e-5           # of max|y|: folded against unfolded in fp64 (fp32-rounded folds)


def vr_spreads(dev, label: str, run, card: str) -> dict:
    """``run()`` (a VR split) twice under cuDNN's default algorithms and
    twice under its deterministic ones: each pair's max|diff| of the stems.
    Where the deterministic pair differs too, one profiled repeat under
    each: the CUDA kernels only the default algorithms launch name the op
    that does not repeat."""
    import torch

    spreads, kernels = {}, {}
    modes = (("default", contextlib.nullcontext), ("deterministic", cudnn_deterministic))
    for name, algos in modes:
        with algos():
            x, y = run(), run()
        spreads[name] = max(float((x[k] - y[k]).abs().max()) for k in y)
    peak = max(float(v.abs().max()) for v in y.values())
    log(f"[loaders] {label} in memory twice: max|diff| {spreads['default']:.3e} under cuDNN's "
        f"default algorithms, {spreads['deterministic']:.3e} under its deterministic ones "
        f"(max|y| {peak:.4g}) | {card}")
    if spreads["deterministic"] != 0.0:
        for name, algos in modes:
            with algos(), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                run()
                sync(dev)
            kernels[name] = {e.key: e.self_device_time_total for e in prof.key_averages()
                             if e.self_device_time_total > 0}
        only = sorted(set(kernels["default"]) - set(kernels["deterministic"]),
                      key=lambda k: -kernels["default"][k])
        log(f"[loaders] {label}, CUDA kernels of one repeat under the default algorithms and "
            f"not under the deterministic ones (device us): "
            + "; ".join(f"{k[:110]} {kernels['default'][k]:.0f}" for k in only)
            + f" | {card}")
        spreads["default_only"] = only
    return spreads


def phase_loaders(dev, sep, vc, audio, card: str) -> dict:
    """The chain's checkpoint formats at full width, written here in the
    upstream containers and names from seeded modules and read back by the
    port's loaders onto the card: (a) each file's tensors equal to its
    module's and on the card, with its bytes, write and load seconds; (b)
    the chain built from the loaded RoFormer, HuBERT, RMVPE and RVC files on
    the 60 s track, counts reset just before and read just after (48 K1 on
    the Hopper routes, 12 K2), against the same chain from the modules in
    memory; (c) HTDemucs, MDX23C and both VR nets from their files on a
    10 s clip against the modules in memory.  Batch norms and recurrent
    biases are first drawn off their initial values
    (``off_their_init``), so the folds the loaders make (RMVPE's GRU biases,
    VR's batch norms and LSTM biases) change numbers.  Where a format stores
    what the loader folds (weight-norm pairs, fp16 RVC tensors, those folds,
    VR's training heads) the module in memory is first brought to what the
    loader should make of its file, so the two should agree bit for bit;
    each folded module is also held in fp64 against the module it was
    written from, on one input, within ``FOLD_TOL``.  Each file is deleted
    once it is loaded."""
    import copy
    import functools
    import os
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.models.crepe import Crepe, CrepePredictor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.separation.htdemucs import HTDemucs, HTDemucsConfig
    from audiolab_tpu_torch.models.separation.mdx23c import MDX23CConfig, TFCTDFNetV3
    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.models.separation.vr_bands import BAND_PARAMS
    from audiolab_tpu_torch.pipelines.rvc import VoiceConverter
    from audiolab_tpu_torch.pipelines.separate import (
        KARAOKE,
        EnsembleMember,
        StemSeparator,
        htdemucs_member,
        mdx23c_member,
        vr_split,
    )
    from audiolab_tpu_torch.train.rvc_train import _hubert_apply_for
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    t_phase = time.perf_counter()
    draws = torch.Generator().manual_seed(213)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_loaders_"))
    weights_dir = os.environ.get("AUDIOLAB_WEIGHTS_DIR")
    files: dict[str, dict] = {}

    through_file = functools.partial(load_through_file, dev, work, files, card)

    def folded_like(module, sd: dict):
        """A copy of ``module`` holding ``sd``."""
        twin = copy.deepcopy(module)
        twin.load_state_dict(sd)
        return twin

    def same_function_fp64(label: str, folded, unfolded, shape) -> None:
        """``folded`` (what a loader made of a file) and ``unfolded`` (the
        module the file was written from) in fp64 on one seeded input."""
        x = torch.randn(shape, generator=draws, dtype=torch.float64).abs().to(dev)
        with torch.no_grad():
            a = copy.deepcopy(folded).double().eval()(x)
            b = copy.deepcopy(unfolded).double().eval()(x)
        d, peak = float((a - b).abs().max()), float(b.abs().max())
        log(f"[loaders] {label} folded by its loader against the module it was written from, "
            f"fp64 on {tuple(shape)}: max|diff| {d:.3e} (tolerance {FOLD_TOL * peak:.3e}: "
            f"{FOLD_TOL:g} of max|y|) | {card}")
        expect(d <= FOLD_TOL * peak, f"loaders {label}: the fold changes the function")

    try:
        # (a) the chain's four formats
        members = []
        for i, m in enumerate(sep.members):
            model = m.apply_fn
            ckpt = {"state_dict": {f"model.{k}": v for k, v in cpu_state(model).items()}}
            got = through_file(f"BS-RoFormer {i}", f"bs_roformer_{i}.ckpt", ckpt,
                               lambda p, c=model.cfg: C.load_roformer_checkpoint(p, c), model)
            members.append(EnsembleMember(m.name, got, m.weight_vocals, m.weight_inst))
        hubert = copy.deepcopy(vc.hubert)
        fairseq = weight_norm_pairs(cpu_state(hubert), HUBERT_WN, dim=2)
        hubert.load_state_dict(C.fold_state_dict(fairseq, dim=2))
        os.environ["AUDIOLAB_WEIGHTS_DIR"] = str(work)
        got_hubert = through_file(
            "HuBERT", "hubert_base.pt", {"model": fairseq},
            lambda p: _hubert_apply_for({"small_hubert": False, "version": "v2"}), hubert)
        rmvpe = off_their_init(copy.deepcopy(vc.rmvpe), 211)
        written = cpu_state(rmvpe)
        want = dict(written)
        C._fold_recurrent_biases(want, lstm=False)
        rmvpe_mem = folded_like(rmvpe, want)
        got_rmvpe = through_file("RMVPE", "rmvpe.pt", written, RMVPE.from_checkpoint, rmvpe_mem)
        same_function_fp64("RMVPE BiGRU", got_rmvpe.fc[0], rmvpe.fc[0],
                           (1, 200, rmvpe.fc[0].gru.input_size))
        del rmvpe
        synth = copy.deepcopy(vc.synth)
        cpt = rvc_process_ckpt(cpu_state(synth), synth.cfg, "48k", "v2")
        synth.load_state_dict(C.fold_state_dict({k: v.float() for k, v in cpt["weight"].items()}))
        got_synth, got_cfg = through_file("RVC v2-48k", "voice.pth", cpt, C.load_rvc_checkpoint,
                                          synth)
        expect(got_cfg == synth.cfg, f"loaders RVC: config {got_cfg} != {synth.cfg}")
        with torch.device(dev):
            crepe = fast_init(Crepe("full"), seed=210)
        off_their_init(crepe, 212)
        through_file("CREPE full", "full.pth", cpu_state(crepe),
                     lambda p: CrepePredictor.from_checkpoint(p).net, crepe)
        del crepe

        # (b) the chain from the loaded files against the chain in memory
        kw = dict(sr=sep.sr, chunk_seconds=sep.chunk_seconds, overlap_seconds=sep.overlap_seconds,
                  device_batch=sep.device_batch, device=dev)
        sep_file = StemSeparator(members, **kw)
        vc_file = VoiceConverter(got_synth, got_hubert, got_rmvpe,
                                 index_features=vc.index_features, cfg=vc.cfg, device=dev)
        vc_mem = VoiceConverter(synth, hubert, rmvpe_mem, index_features=vc.index_features,
                                cfg=vc.cfg, device=dev)
        stems_f, l_sep, sep_s = phase_separator(dev, sep_file, audio, 48)
        _, out_f, l_rvc, rvc_s = phase_rvc(dev, vc_file, stems_f["vocals"], 12)
        launches = {k: l_sep[k] + l_rvc[k] for k in KERNELS}
        stems_m, _, _ = phase_separator(dev, sep, audio, 48)
        _, out_m, _, _ = phase_rvc(dev, vc_mem, stems_m["vocals"], 12)
        d_stems = max(float((stems_f[k] - stems_m[k]).abs().max()) for k in stems_m)
        d_out = float((out_f - out_m).abs().max())
        same = all(torch.equal(stems_f[k], stems_m[k]) for k in stems_m) and torch.equal(
            out_f, out_m)
        tol = 1e-6 * float(out_m.abs().max())
        log(f"[loaders] the chain from the files: separate {sep_s:.3f} s, RVC {rvc_s:.3f} s, "
            f"launches {launches}; against the chain in memory: bit-equal {same}, stems "
            f"max|diff| {d_stems:.3e}, RVC output max|diff| {d_out:.3e} (tolerance "
            f"{tol:.3e}: 1e-6 of max|y|) | {card}")
        expect(launches["K1"] == 48 and launches["K2"] == 12
               and all(launches[k] == 0 for k in KERNELS if k not in ("K1", "K2")),
               f"loaders: launches {launches}, expected K1 48 and K2 12")
        expect(d_stems <= 1e-6 * float(max(v.abs().max() for v in stems_m.values()))
               and d_out <= tol, "loaders: the chain from the files differs from the modules'")
        del sep_file, vc_file, vc_mem, members, got_synth, got_hubert, got_rmvpe, rmvpe_mem
        del synth, hubert
        del stems_f, stems_m, out_f, out_m
        torch.cuda.empty_cache()

        # (c) the rest of the separator family on a clip
        clip = audio[:, : int(LOADERS_CLIP_S * SEP_SR)]
        with torch.device(dev):
            htd = fast_init(HTDemucs(HTDemucsConfig()), seed=201)
            mdx = fast_init(TFCTDFNetV3(MDX23CConfig()), seed=200)
        got_htd = through_file("HTDemucs 6s", "htdemucs_6s.th", cpu_state(htd),
                               lambda p: C.load_htdemucs_checkpoint(p, htd.cfg), htd)
        got_mdx = through_file("MDX23C InstVoc_HQ", "MDX23C-8KFFT-InstVoc_HQ.ckpt",
                               mdx23c_upstream_names(cpu_state(mdx)),
                               lambda p: C.load_mdx23c_checkpoint(p, mdx.cfg), mdx)
        runs = {}      # label: (the split from the file, the split in memory)
        for label, make, pair in (("HTDemucs 6s", htdemucs_member, (got_htd, htd)),
                                  ("MDX23C InstVoc_HQ", mdx23c_member, (got_mdx, mdx))):
            runs[label] = tuple(
                lambda m=make(net): StemSeparator([m], **kw).separate(clip, as_numpy=False)
                for net in pair)
        for arch, band in VR_CASES:
            bins = BAND_PARAMS[band]["bins"]
            with torch.device(dev):
                net = fast_init(make_vr_net(VRConfig(arch=arch, n_fft=2 * bins)), seed=200)
            off_their_init(net, 214)
            written = cpu_state(net)
            want = dict(written)       # what the loader should make of the file
            C._fold_batch_norms(want)
            C._fold_recurrent_biases(want, lstm=True)
            for k, v in want.items():
                if k.split(".")[0] in ("aux_out", "aux1_out", "aux2_out"):
                    want[k] = torch.zeros_like(v)
            net_mem = folded_like(net, want)
            label = f"VR {arch}"
            got_vr = through_file(label, f"vr_{arch}.pth", written,
                                  lambda p, a=arch, b=bins: C.load_vr_checkpoint(
                                      p, n_fft=2 * b if a == "cascaded_asppnet" else None),
                                  net_mem)
            same_function_fp64(label, got_vr, net, (1, 2, bins + 1, 128))
            del net
            runs[label] = tuple(
                lambda split=vr_split(g, band, KARAOKE, device=dev): split(clip, as_numpy=False)
                for g in (got_vr, net_mem))
        separated = {}
        for label, (from_file, in_memory) in runs.items():
            algos = contextlib.nullcontext()
            spreads = None
            if label.startswith("VR "):
                # each VR net in memory twice under cuDNN's default algorithms
                # and twice under its deterministic ones: the comparison runs
                # on the deterministic ones where only they repeat
                spreads = vr_spreads(dev, label, in_memory, card)
                if spreads["default"] != 0.0 and spreads["deterministic"] == 0.0:
                    algos = cudnn_deterministic()
            with algos:
                reset_counts()
                t0 = time.perf_counter()
                a = from_file()
                sync(dev)
                secs = time.perf_counter() - t0
                member_launches = counts()
                b = in_memory()
            d = max(float((a[k] - b[k]).abs().max()) for k in b)
            peak = max(float(v.abs().max()) for v in b.values())
            finite = all(bool(torch.isfinite(v).all()) for v in a.values())
            separated[label] = dict(seconds=secs, max_abs_diff=d, launches=member_launches,
                                    spreads=spreads)
            on = "" if isinstance(algos, contextlib.nullcontext) else "; cuDNN deterministic"
            log(f"[loaders] {label} from its file on {LOADERS_CLIP_S:.0f} s{on}: stems "
                f"{sorted(a)} finite {finite}, {secs:.3f} s, launches {member_launches}; against "
                f"the module in memory max|diff| {d:.3e} (tolerance {1e-6 * peak:.3e}: 1e-6 of "
                f"max|y|)")
            expect(set(a) == set(b) and finite, f"loaders {label}: stems")
            expect(d <= 1e-6 * peak, f"loaders {label}: differs from the module in memory")
    finally:
        if weights_dir is None:
            os.environ.pop("AUDIOLAB_WEIGHTS_DIR", None)
        else:
            os.environ["AUDIOLAB_WEIGHTS_DIR"] = weights_dir
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[loaders] {len(files)} files, {sum(f['bytes'] for f in files.values()) / 2**30:.2f} "
        f"GiB written in {sum(f['write_s'] for f in files.values()):.1f} s and loaded in "
        f"{sum(f['load_s'] for f in files.values()):.1f} s; phase {phase_s:.1f} s | {card}")
    return dict(launches=launches, files=files, separated=separated, phase_s=phase_s)


LISTEN_SPANS = (5.0, 10.0)       # the aligner's spans from its file, 12 words each
LISTEN_DIARIZE_S = 60.0
LISTEN_SCALE_FACTOR = 0.8532     # the AudioSR checkpoint's latent scale_factor
MATCH_TOL = 1e-6                 # of max|y|: a loaded model against its twin in memory


def twin(module, sd: dict):
    """A copy of ``module`` holding ``sd``: the twin in memory of a module
    loaded from its file."""
    import copy

    out = copy.deepcopy(module)
    out.load_state_dict(sd)
    return out


def twin_run(dev, card: str, tag: str, runs: dict, path: dict, label: str, from_file,
             in_memory, expect_k2: int = 0, exact: bool = False):
    """Run ``from_file`` and ``in_memory`` (a model loaded from its file and
    its twin in memory), counts reset just before and read just after each;
    the launches must be equal (``expect_k2`` K2 and nothing else on the
    card) and the outputs equal: bit for bit with ``exact``, else within
    MATCH_TOL of max|y| for tensors.  Records the run in ``runs[label]``,
    adds the file's launches to ``path`` and returns its output."""
    import torch

    def run(fn):
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0, counts()

    a, secs, la = run(from_file)
    b, secs_m, lb = run(in_memory)
    if torch.is_tensor(a) or isinstance(a, np.ndarray):
        a64, b64 = (torch.as_tensor(x).double().cpu() for x in (a, b))
        same = torch.equal(a64, b64)
        d, peak = float((a64 - b64).abs().max()), float(b64.abs().max())
        finite = bool(torch.isfinite(a64).all())
        err = f"max|diff| {d:.3e} (tolerance {MATCH_TOL * peak:.3e}: {MATCH_TOL:g} of max|y|)"
        ok = finite and (same or (not exact and d <= MATCH_TOL * peak))
    else:
        same = ok = a == b
        d, err = 0.0 if same else float("inf"), "equal" if same else "differ"
    runs[label] = dict(seconds=secs, seconds_twin=secs_m, launches=la, bit_equal=same,
                       max_abs_diff=d)
    for k in path:
        path[k] += la[k]
    log(f"{tag} {label}: from the files {secs:.3f} s, launches {la}; the twin in memory "
        f"{secs_m:.3f} s, launches {lb}; bit-equal {same}, {err} | {card}")
    want = {k: (expect_k2 if k == "K2" and dev.type == "cuda" else 0) for k in KERNELS}
    expect(la == lb == want, f"{tag} {label}: launches {la} / {lb}, expected {want}")
    expect(ok, f"{tag} {label}: the run from the files differs from the twin's"
               + (" (bit equality asked)" if exact else ""))
    return a


def phase_loaders_listen(dev, card: str) -> dict:
    """The Super Resolution, transcription, diarization and alignment
    checkpoint formats at full width, written here in the upstream
    containers and names from the seeded modules of phases ``diffusion``
    and ``transcribe`` (``build_audiosr``, ``build_whisper``, ``build_w2v``,
    ``build_pyannet``, ``build_rtla``; the WeSpeaker ResNet of phase
    ``chatterbox``), batch norms and LSTM biases drawn off their initial
    values first (``off_their_init``), and read back by the port's loaders
    onto the card: each file's tensors equal to its twin's (the module in
    memory brought to what the loader should make of its file: weight-norm
    pairs, batch norms and LSTM biases folded, Whisper's fp16), with its
    bytes, write and load seconds.  (a) One whole AudioSR ``.ckpt`` (VAE,
    UNet, vocoder with weight-norm pairs, ``scale_factor``): the guided DDIM
    (DIFF_DDIM_STEPS steps) on one 10.24 s stereo chunk.  (b) Whisper's
    ``.pt`` (``dims``, fp16 ``model_state_dict``) at large-v3's dimensions:
    the TR_TOKENS-token decode of a 30 s window, then the uncached forward
    over its tokens (32 fp32 K2).  (c) HF ``Wav2Vec2ForCTC``'s
    ``pytorch_model.bin``: the aligner on the LISTEN_SPANS spans (12 K2
    each).  (d) pyannote's segmentation file (Lightning's ``model.``) and
    WeSpeaker's ``pytorch_model.bin`` (``resnet.``): NeuralDiarizer with
    both loaded stages on LISTEN_DIARIZE_S of two speakers.  (e) RTLA's
    ``.pt`` and its ``.safetensors`` + JSON pair: the posteriorgram of 30 s.
    Each run from the files and its twin's run get counts reset just
    before and read just after; launches must be equal and outputs equal
    (within MATCH_TOL of max|y| for tensors, printed).  Returns the path's
    launches: the runs from the files."""
    import functools
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.models.diarize import NeuralDiarizer
    from audiolab_tpu_torch.models.rtla import phoneme_features
    from audiolab_tpu_torch.models.wav2vec2 import CTCWordAligner
    from audiolab_tpu_torch.models.whisper import (
        WhisperConfig,
        WhisperModel,
        log_mel_30s,
        sinusoids,
        transcribe_window,
    )
    from audiolab_tpu_torch.pipelines.super_res import AudioSRCheckpointPipeline
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.weights import wav2vec2_to_hf

    cuda = dev.type == "cuda"
    tag = "[loaders_listen]"
    t_phase = time.perf_counter()
    draws = torch.Generator().manual_seed(221)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_loaders_listen_"))
    files: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    path = dict.fromkeys(KERNELS, 0)
    through_file = functools.partial(load_through_file, dev, work, files, card, tag=tag)

    both = functools.partial(twin_run, dev, card, tag, runs, path)

    try:
        # (a) one whole AudioSR checkpoint
        vae, unet, voc = build_audiosr(dev)
        voc_pairs = weight_norm_pairs(cpu_state(voc), AUDIOSR_VOCODER_WN)
        voc_mem = twin(voc, C.fold_state_dict(voc_pairs))
        del voc
        ckpt = {f"first_stage_model.{k}": v for k, v in cpu_state(vae).items()}
        ckpt.update({f"first_stage_model.vocoder.{k}": v for k, v in voc_pairs.items()})
        ckpt.update({f"model.diffusion_model.{k}": v for k, v in cpu_state(unet).items()})
        ckpt["scale_factor"] = torch.tensor(LISTEN_SCALE_FACTOR)
        del voc_pairs

        def parts(got):
            return {f"{n}.{k}": v for n, m in zip(("vae", "unet", "vocoder"), got[:3])
                    for k, v in m.state_dict().items()}

        got = through_file(
            "AudioSR (VAE, UNet, vocoder, scale_factor)", "audiosr.ckpt", ckpt,
            lambda p: (C.load_audiosr_vae_checkpoint(p, device=dev),
                       C.load_audiosr_unet_checkpoint(p, device=dev),
                       C.load_audiosr_vocoder_checkpoint(p, device=dev),
                       C.load_audiosr_scale_factor(p)),
            parts((vae, unet, voc_mem)), state_of=parts)
        del ckpt
        sf = float(np.float32(LISTEN_SCALE_FACTOR))
        expect(got[3] == sf, f"{tag} AudioSR scale_factor {got[3]} != {sf}")
        pipe_f = AudioSRCheckpointPipeline(*got[:3], scale_factor=got[3])
        pipe_m = AudioSRCheckpointPipeline(vae, unet, voc_mem, scale_factor=sf)
        chunk = torch.from_numpy(np.stack([harmonic_tone(48000, 491520, 196.0, 60),
                                           harmonic_tone(48000, 491520, 247.0, 61)])[None]).to(dev)
        both(f"AudioSR enhance_chunks (10.24 s stereo, {DIFF_DDIM_STEPS} DDIM steps)",
             lambda: pipe_f.enhance_chunks(chunk, steps=DIFF_DDIM_STEPS, seed=1),
             lambda: pipe_m.enhance_chunks(chunk, steps=DIFF_DDIM_STEPS, seed=1))
        del pipe_f, pipe_m, got, vae, unet, voc_mem, chunk
        torch.cuda.empty_cache()

        # (b) Whisper's .pt at large-v3's dimensions, fp16 as openai ships it
        whisper = build_whisper(dev)
        with torch.no_grad():
            for p in whisper.parameters():
                p.copy_(p.half().float())
        cfg = whisper.cfg
        sd16 = {k: v.half() for k, v in cpu_state(whisper).items()}
        sd16["encoder.positional_embedding"] = torch.from_numpy(
            sinusoids(cfg.n_audio_ctx, cfg.dim)).half()
        dims = {k: WHISPER_LARGE_V3[k] for k in ("n_mels", "n_audio_ctx", "vocab_size")}

        def load_whisper(p):
            with torch.device(dev):
                empty = WhisperModel(WhisperConfig(**WHISPER_LARGE_V3))
            sd = torch.load(p, map_location="cpu", weights_only=True)["model_state_dict"]
            return C.load_whisper_state(empty, sd).eval()

        whisper_f = through_file("Whisper large-v3 dimensions (fp16)", "large-v3.pt",
                                 {"dims": dims, "model_state_dict": sd16}, load_whisper, whisper)
        del sd16
        mel = log_mel_30s(_two_speakers(30.0, 16000), cfg, dev)
        toks = both(f"Whisper transcribe_window ({TR_TOKENS} tokens, one 30 s window)",
                    lambda: transcribe_window(whisper_f, mel, TR_TOKENS, device=dev),
                    lambda: transcribe_window(whisper, mel, TR_TOKENS, device=dev))
        tokens_in = torch.cat([torch.full((1, 1), cfg.sot, device=dev), toks[:, :-1]], dim=1)
        with torch.inference_mode():
            both("Whisper uncached forward over SOT + 63 decoded tokens",
                 lambda: whisper_f(mel, tokens_in), lambda: whisper(mel, tokens_in),
                 expect_k2=cfg.n_text_layers)
        del whisper, whisper_f, mel
        torch.cuda.empty_cache()

        # (c) HF Wav2Vec2ForCTC's pytorch_model.bin
        w2v = build_w2v(dev)
        pairs = weight_norm_pairs(cpu_state(w2v), W2V_WN, dim=2)
        w2v_mem = twin(w2v, C.fold_state_dict(pairs, dim=2))
        del w2v
        hf = wav2vec2_to_hf(pairs)
        hf["wav2vec2.masked_spec_embed"] = torch.rand(768, generator=draws)
        aligner_f = through_file("wav2vec2-base-960h widths", "pytorch_model.bin", hf,
                                 lambda p: C.load_wav2vec2_checkpoint(p, device=dev), w2v_mem,
                                 state_of=lambda a: a.model.state_dict())
        aligner_m = CTCWordAligner(w2v_mem, device=dev)
        x = _two_speakers(max(LISTEN_SPANS) + 1.0, 16000)
        for span in LISTEN_SPANS:
            both(f"aligner align_words over {span:g} s (12 words)",
                 lambda: aligner_f.align_words(x, 16000, 0.5, 0.5 + span, TR_WORDS),
                 lambda: aligner_m.align_words(x, 16000, 0.5, 0.5 + span, TR_WORDS),
                 expect_k2=12)
            seg = x[8000: int((0.5 + span) * 16000)]
            both(f"aligner log-probs over {span:g} s",
                 lambda: aligner_f.log_probs(seg), lambda: aligner_m.log_probs(seg),
                 expect_k2=12)
        del aligner_f, aligner_m, w2v_mem, hf, pairs
        torch.cuda.empty_cache()

        # (d) the diarizer's two stages from their files
        pn = off_their_init(build_pyannet(dev), 215)
        with torch.no_grad():
            # speaker 0 alone in every frame: regions for the WeSpeaker back end
            pn.classifier.bias.copy_(torch.tensor([-4.0, 4.0, -4.0, -4.0, -4.0, -4.0, -4.0]))
        seg_file = {f"model.{k}": v for k, v in cpu_state(pn).items()}
        seg_file["model.sincnet.conv1d.0.filterbank.window_"] = torch.hann_window(125)
        seg_file["model.sincnet.conv1d.0.filterbank.n_"] = torch.arange(125.0)
        seg_want = cpu_state(pn)
        C._fold_recurrent_biases(seg_want, lstm=True)
        del pn
        seg_f = through_file("PyanNet segmentation-3.0 widths", "segmentation.bin", seg_file,
                             lambda p: C.load_pyannet_checkpoint(p, device=dev), seg_want,
                             state_of=lambda sd: sd)
        ws = off_their_init(build_wespeaker(dev), 216)
        ws_file = {f"resnet.{k}": v for k, v in cpu_state(ws).items()}
        ws_file["resnet.projection.weight"] = torch.rand(5994, 256, generator=draws)
        ws_want = cpu_state(ws)
        C._fold_batch_norms(ws_want)
        ws_mem = twin(ws, ws_want)
        del ws
        ws_f = through_file("WeSpeaker ResNet34", "wespeaker.bin", ws_file,
                            lambda p: C.load_wespeaker_checkpoint(p, device=dev), ws_mem)
        diar_f = NeuralDiarizer(pyannet_params=seg_f, wespeaker=ws_f, device=dev)
        diar_m = NeuralDiarizer(pyannet_params={k: v.to(dev) for k, v in seg_want.items()},
                                wespeaker=ws_mem, device=dev)
        two = _two_speakers(LISTEN_DIARIZE_S, 16000)
        turns = both(f"NeuralDiarizer with both loaded stages ({LISTEN_DIARIZE_S:g} s)",
                     lambda: diar_f.diarize(two, 16000), lambda: diar_m.diarize(two, 16000))
        expect(len(turns) > 0, f"{tag} the diarizer found no turn")
        log(f"{tag} the diarizer: {len(turns)} turns, speakers "
            f"{sorted({t[2] for t in turns})}")
        del diar_f, diar_m, seg_f, ws_f, ws_mem

        # (e) RTLA's .pt and its .safetensors + JSON pair
        rtla = off_their_init(build_rtla(dev), 217)
        rtla_want = cpu_state(rtla)
        C._fold_batch_norms(rtla_want)
        C._fold_recurrent_biases(rtla_want, lstm=True)
        rtla_mem = twin(rtla, rtla_want)
        c = rtla.cfg
        config = {"n_mels": c.n_mels, "num_lbl": c.num_lbl,
                  "model_complexity": c.model_complexity}

        def write_pair(p, sd):
            write_safetensors(p, sd)
            Path(p).with_suffix(".json").write_text(json.dumps({"config": config}))

        rtla_pt = through_file("RTLA CRNN (.pt)", "model.pt",
                               {"model_state_dict": cpu_state(rtla), "config": config},
                               lambda p: C.load_rtla_crnn_checkpoint(p, device=dev), rtla_mem)
        rtla_st = through_file(
            "RTLA CRNN (.safetensors + JSON)", "pretrained-model.safetensors", cpu_state(rtla),
            lambda p: C.load_rtla_crnn_checkpoint(p, str(Path(p).with_suffix(".json")),
                                                  device=dev), rtla_mem, write=write_pair)
        expect(rtla_pt.cfg == rtla_st.cfg == c, f"{tag} RTLA config {rtla_pt.cfg}")
        master = gliding_notes(np.full(int(ALIGN_S / 0.5), 0.5), 0)
        for label, got in (("(.pt)", rtla_pt), ("(.safetensors)", rtla_st)):
            both(f"RTLA posteriorgram {label} of {ALIGN_S:g} s",
                 lambda g=got: phoneme_features(master, 16000, g, device=dev),
                 lambda: phoneme_features(master, 16000, rtla_mem, device=dev))
        del rtla, rtla_mem, rtla_pt, rtla_st
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"{tag} {len(files)} files, {sum(f['bytes'] for f in files.values()) / 2**30:.2f} "
        f"GiB written in {sum(f['write_s'] for f in files.values()):.1f} s and loaded in "
        f"{sum(f['load_s'] for f in files.values()):.1f} s; the path's launches {path}; "
        f"phase {phase_s:.1f} s | {card}")
    expect(path["K2"] > 0 or not cuda, f"{tag} K2 was not launched on the path")
    return dict(launches=path, files=files, runs=runs, phase_s=phase_s)


SPEECH_DVAE_FRAMES = 400       # mel frames of the DVAE's encode -> decode on the card


def phase_loaders_speech(dev, card: str) -> dict:
    """The speech engines' checkpoint formats at full width, written here in
    the upstream containers and names from the seeded modules of phase
    ``engines`` (``build_xtts_v2``, ``build_dia``, ``build_dac``), and read
    back by the port's loaders onto the card: each file's tensors equal to
    its twin's (the module in memory brought to what the loader should make
    of its file: the weight-norm pairs folded), with its bytes, write and
    load seconds.  (a) XTTS-v2: one ``model.pth`` with the five parts under
    Coqui's prefixes (the HiFi decoder's pairs with the gains drawn off, the
    speaker encoder's batch norms drawn off their initial values, a mel front
    end's buffer), each of the five loaders reading the whole file, and
    ``dvae.pth`` at ``XttsDVAE()`` with its EMA buffers; XttsCheckpointEngine
    from the loaded modules runs ``conditioning`` on a 6 s reference and
    XTTS_STEPS ``synthesize`` steps, the DVAE encodes and decodes
    SPEECH_DVAE_FRAMES mel frames.  (b) Dia at ``DiaConfig()`` as
    ``.safetensors`` and the DAC at decoder_dim 1536 as ``weights.pth``
    (``state_dict`` with weight-norm pairs, the encoder and ``in_proj``
    beside it): DiaTTSEngine from both on phase ``engines``' 27-word line
    (12 fp32 K2).  (c) Dia at Dia-1.6B's decoder geometry (DIA16) as
    ``.safetensors``: one teacher-forced forward over BOS + a 5 s prompt
    (18 fp32 K2).  Each run from the files and its twin's run get counts
    reset just before and read just after; launches must be equal and every
    output bit-equal.  Returns the path's launches: the runs from the
    files."""
    import functools
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.models.dia import DiaConfig, tokenize_dialogue
    from audiolab_tpu_torch.models.xtts import XttsDVAE
    from audiolab_tpu_torch.models.zonos import delay_pattern
    from audiolab_tpu_torch.pipelines.tts import DiaTTSEngine, XttsCheckpointEngine
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    tag = "[loaders_speech]"
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_loaders_speech_"))
    files: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    path = dict.fromkeys(KERNELS, 0)
    through_file = functools.partial(load_through_file, dev, work, files, card, tag=tag)
    both = functools.partial(twin_run, dev, card, tag, runs, path, exact=True)

    def named(prefixes, modules):
        return {f"{pre}{k}": v for pre, m in zip(prefixes, modules)
                for k, v in m.state_dict().items()}

    try:
        # (a) XTTS-v2's model.pth and dvae.pth
        gpt, cond, perc, spk, hifi = build_xtts_v2(dev)
        off_their_init(spk, 221)
        hifi_pairs = gains_off(weight_norm_pairs(cpu_state(hifi), XTTS_HIFI_WN), 222)
        hifi_mem = twin(hifi, C.fold_state_dict(hifi_pairs))
        del hifi
        prefixes = ("gpt.", "gpt.conditioning_encoder.", "gpt.conditioning_perceiver.",
                    "hifigan_decoder.speaker_encoder.")
        ckpt = {k: v.detach().cpu() for k, v in named(prefixes, (gpt, cond, perc, spk)).items()}
        ckpt.update({f"hifigan_decoder.waveform_decoder.{k}": v for k, v in hifi_pairs.items()})
        ckpt["torch_mel_spectrogram_style_encoder.mel_stft.mel_basis"] = torch.rand(
            80, 513, generator=torch.Generator().manual_seed(223))
        del hifi_pairs
        parts = ("gpt.", "cond.", "perc.", "spk.", "hifi.")
        loaded = through_file(
            "XTTS-v2 model.pth (GPT-2, conditioning encoder, perceiver, speaker encoder, "
            "HiFi decoder)", "model.pth", ckpt,
            lambda p: (C.load_xtts_gpt_checkpoint(p, device=dev),
                       C.load_xtts_conditioner_checkpoint(p, device=dev),
                       C.load_xtts_perceiver_checkpoint(p, device=dev),
                       C.load_xtts_speaker_checkpoint(p, device=dev),
                       C.load_xtts_hifigan_checkpoint(p, device=dev)),
            named(parts, (gpt, cond, perc, spk, hifi_mem)), state_of=lambda got: named(parts, got))
        del ckpt
        with torch.device(dev):
            dvae = fast_init(XttsDVAE(), 15).eval()
        dvae_file = cpu_state(dvae)
        g = torch.Generator().manual_seed(224)
        cdim, n_tok = dvae.codebook.embed.shape
        dvae_file["codebook.cluster_size"] = torch.rand(n_tok, generator=g)
        dvae_file["codebook.embed_avg"] = torch.rand(cdim, n_tok, generator=g)
        dvae_f = through_file("XTTS-v2 dvae.pth", "dvae.pth", dvae_file,
                              lambda p: C.load_xtts_dvae_checkpoint(p, device=dev), dvae)
        del dvae_file
        ck_f = XttsCheckpointEngine(*loaded, device=dev)
        ck_m = XttsCheckpointEngine(gpt, cond, perc, spk, hifi_mem, device=dev)
        ref24 = _tone(XTTS_REF_S, 24000)
        voices: dict = {}

        def conditioning(name, eng):
            def run():
                voices[name] = eng.conditioning(ref24, 24000)
                return torch.cat([t.flatten() for t in voices[name]])
            return run

        both(f"XTTS-v2 conditioning on {XTTS_REF_S:g} s (perceiver latents and d-vector)",
             conditioning("file", ck_f), conditioning("memory", ck_m))
        both(f"XTTS-v2 synthesize ({XTTS_STEPS} steps, the HiFi decoder)",
             lambda: ck_f.synthesize(XTTS_TEXT, cond=voices["file"][0],
                                     d_vector=voices["file"][1], max_steps=XTTS_STEPS, seed=0)[0],
             lambda: ck_m.synthesize(XTTS_TEXT, cond=voices["memory"][0],
                                     d_vector=voices["memory"][1], max_steps=XTTS_STEPS,
                                     seed=0)[0])
        mel = torch.randn(1, SPEECH_DVAE_FRAMES, 80, generator=torch.Generator().manual_seed(225))
        mel = mel.to(dev)
        with torch.inference_mode():
            both(f"XTTS-v2 DVAE encode -> decode ({SPEECH_DVAE_FRAMES} mel frames)",
                 lambda: dvae_f.decode(dvae_f.encode(mel)), lambda: dvae.decode(dvae.encode(mel)))
        del ck_f, ck_m, loaded, gpt, cond, perc, spk, hifi_mem, dvae, dvae_f, voices, mel
        torch.cuda.empty_cache()

        # (b) Dia at DiaConfig() (.safetensors) and the DAC's weights.pth
        dia, dac = build_dia(dev), build_dac(dev)
        dac_pairs = gains_off(weight_norm_pairs(cpu_state(dac), DAC_WN), 226)
        dac_mem = twin(dac, C.fold_state_dict(dac_pairs))
        del dac
        dac_file = {"state_dict": {**dac_pairs, **dac_encoder_state(227)},
                    "metadata": {"kwargs": {"sample_rate": 44100, "decoder_dim": 1536}}}
        dia_f = through_file("Dia DiaConfig() (.safetensors)", "model.safetensors",
                             cpu_state(dia),
                             lambda p: C.load_dia_checkpoint(p, DiaConfig(), device=dev), dia,
                             write=write_safetensors)
        dac_f, dac_cfg = through_file("DAC 44.1 kHz weights.pth (decoder_dim 1536)",
                                      "weights.pth", dac_file,
                                      lambda p: C.load_dac_checkpoint(p, device=dev), dac_mem)
        expect(dac_cfg == dac_mem.cfg, f"{tag} DAC config {dac_cfg} != {dac_mem.cfg}")
        del dac_file, dac_pairs
        eng_f = DiaTTSEngine(dia_f, dac_f, device=dev)
        eng_m = DiaTTSEngine(dia, dac_mem, device=dev)
        both(f"DiaTTSEngine with the DAC ({len(DIA_TEXT.split())} words, "
             f"{eng_f.frames(DIA_TEXT)} frames, CFG batch 2)",
             lambda: eng_f.generate(DIA_TEXT, seed=0)[0],
             lambda: eng_m.generate(DIA_TEXT, seed=0)[0], expect_k2=dia.cfg.n_layers_dec)
        del eng_f, eng_m, dia, dia_f, dac_f, dac_mem
        torch.cuda.empty_cache()

        # (c) Dia-1.6B's decoder geometry (.safetensors): one teacher-forced forward
        dia = build_dia(dev, 2, **DIA16)
        dia_f = through_file("Dia-1.6B decoder geometry (.safetensors)", "model.safetensors",
                             cpu_state(dia),
                             lambda p: C.load_dia_checkpoint(p, DiaConfig(**DIA16), device=dev),
                             dia, write=write_safetensors)
        c = dia.cfg
        gp = torch.Generator(device=dev).manual_seed(11)
        prompt = torch.randint(0, 1024, (1, c.n_codebooks, DIA_PROMPT_FRAMES), generator=gp,
                               device=dev)
        bos = torch.full((1, c.n_codebooks, 1), c.bos_id, dtype=torch.long, device=dev)
        seq = torch.cat([bos, delay_pattern(prompt, c.masked_id)], dim=2)
        text = torch.as_tensor(tokenize_dialogue(DIA_TEXT)[None], dtype=torch.long, device=dev)
        with torch.inference_mode():
            both(f"Dia-1.6B teacher-forced forward over {seq.shape[2]} positions",
                 lambda: dia_f(text, seq, text != 0), lambda: dia(text, seq, text != 0),
                 expect_k2=c.n_layers_dec)
        del dia, dia_f
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"{tag} {len(files)} files, {sum(f['bytes'] for f in files.values()) / 2**30:.2f} "
        f"GiB written in {sum(f['write_s'] for f in files.values()):.1f} s and loaded in "
        f"{sum(f['load_s'] for f in files.values()):.1f} s; the path's launches {path}; "
        f"phase {phase_s:.1f} s | {card}")
    expect(path["K2"] > 0 or not cuda, f"{tag} K2 was not launched on the path")
    return dict(launches=path, files=files, runs=runs, phase_s=phase_s)


# OpenVoice's converter: the reference encoder's six Conv2d beside RVC_WN's
# WaveNet layers and HiFiGAN convolutions; S3Gen's HiFT: the f0 predictor's
# convolutions, conv_pre, conv_post, the up-convolutions and both residual
# stacks (source_downs carries none)
OPENVOICE_WN = re.compile(r"^ref_enc\.convs\.\d+\.weight$|" + RVC_WN.pattern)
HIFT_WN = re.compile(r"^mel2wav\.(f0_predictor\.condnet\.\d+|conv_pre|conv_post|ups\.\d+"
                     r"|(source_)?resblocks\.\d+\.convs[12]\.\d+)\.weight$")


def zonos_config_conditioners(specs) -> list[dict]:
    """A Zonos ``config.json``'s ``prefix_conditioner.conditioners`` list for
    ``specs`` (``models/zonos.CondSpec``): each entry's type and name, and
    the fields that differ from their defaults, as the published file
    writes them."""
    import dataclasses

    out = []
    for s in specs:
        d = {"type": s.type, "name": s.name}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if f.name not in d and v != f.default:
                d[f.name] = v
        out.append(d)
    return out


def bpe_tokenizer_json(text: str, merges=(), added=("[STOP]", "[UNK]", "[SPACE]")) -> dict:
    """A ``tokenizers`` JSON of the layout ``BpeTokenizer`` reads: ``added``
    as special tokens first (ids 0, 1, ...), then each character of
    ``text`` but the space, then the product of each merge, the
    ``Whitespace`` pre-tokenizer and ``[UNK]`` for what the vocab lacks."""
    vocab = {t: i for i, t in enumerate(added)}
    for ch in sorted(set(text) - {" "}):
        vocab.setdefault(ch, len(vocab))
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    return {"version": "1.0",
            "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": False,
                              "special": True} for t in added],
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "vocab": vocab, "merges": list(merges)}}


def chatterbox_conds(speaker_emb, prompt_tokens, ref_tokens, ref_mel, ref_xvector) -> dict:
    """A ``conds.pt`` as chatterbox's ``Conditionals.save`` writes it: the
    T3 conditionals and the S3Gen reference dict, each a dict of tensors
    (the unused ones None)."""
    import torch

    t = torch.as_tensor
    return {"t3": {"speaker_emb": t(speaker_emb).reshape(1, -1).float(), "clap_emb": None,
                   "cond_prompt_speech_tokens": t(prompt_tokens).reshape(1, -1).long(),
                   "cond_prompt_speech_emb": None, "emotion_adv": torch.full((1, 1, 1), 0.5)},
            "gen": {"prompt_token": t(ref_tokens).reshape(1, -1).long(),
                    "prompt_token_len": torch.tensor([int(np.asarray(ref_tokens).size)]),
                    "prompt_feat": t(ref_mel).float(), "prompt_feat_len": None,
                    "embedding": t(ref_xvector).reshape(1, -1).float()}}


def write_chatterbox_dir(root: Path, t3: dict, ve: dict, s3gen: dict, campplus: dict | None = None,
                         s3tok: dict | None = None, tokenizer: dict | None = None,
                         conds: dict | None = None) -> dict:
    """resemble-ai Chatterbox's published directory in ``root``:
    ``t3_cfg.safetensors``, ``ve.safetensors``, ``s3gen.safetensors``
    (``flow.*`` and ``mel2wav.*``, with CAMPPlus under ``speaker_encoder.``
    and the S3 tokenizer under ``tokenizer.`` where given), and the optional
    ``tokenizer.json`` and ``conds.pt``.  Returns each file's bytes and
    write seconds."""
    import torch

    bundle = dict(s3gen)
    for prefix, part in (("speaker_encoder.", campplus), ("tokenizer.", s3tok)):
        bundle.update({f"{prefix}{k}": v for k, v in (part or {}).items()})
    files = {"t3_cfg.safetensors": t3, "ve.safetensors": ve, "s3gen.safetensors": bundle}
    if tokenizer is not None:
        files["tokenizer.json"] = tokenizer
    if conds is not None:
        files["conds.pt"] = conds
    out = {}
    for name, obj in files.items():
        p = root / name
        t0 = time.perf_counter()
        if name.endswith(".safetensors"):
            write_safetensors(p, obj)
        elif name.endswith(".json"):
            p.write_text(json.dumps(obj))
        else:
            torch.save(obj, p)
        out[name] = dict(bytes=p.stat().st_size, write_s=time.perf_counter() - t0)
    return out


# stable_audio_tools' Oobleck decoder: every convolution (WNConv1d and
# WNConvTranspose1d); ACE-Step's music_vocoder: the head's conv_pre, up-
# convolutions, residual convolutions and conv_post
OOBLECK_WN = re.compile(r"^layers\.(\d+\.layers\.)*\d+\.weight$")
ADAMOS_WN = re.compile(r"^head\.(conv_pre|conv_post|ups\.\d+|resblocks\.\d+\.convs[12]\.\d+)"
                       r"\.weight$")


def stable_audio_state(dit: dict, decoder: dict, seconds_start: dict, seconds_total: dict,
                       encoder: dict | None = None) -> dict:
    """stable-audio-open's ``model.safetensors`` from the parts' state_dicts:
    the DiT under ``model.model.``, the Oobleck decoder (and the encoder,
    where given) under ``pretransform.model.``, each seconds embedder under
    ``conditioner.conditioners.{seconds_start,seconds_total}.embedder.``."""
    out = {f"model.model.{k}": v for k, v in dit.items()}
    out.update((f"pretransform.model.decoder.{k}", v) for k, v in decoder.items())
    out.update((f"pretransform.model.encoder.{k}", v) for k, v in (encoder or {}).items())
    for which, part in (("seconds_start", seconds_start), ("seconds_total", seconds_total)):
        out.update((f"conditioner.conditioners.{which}.embedder.{k}", v) for k, v in part.items())
    return out


def t5_file_state(t5: dict, shared: bool = True, embed_tokens: bool = False,
                  decoder: dict | None = None) -> dict:
    """transformers' T5 / UMT5 checkpoint of an encoder state_dict ``t5``:
    the embedding as ``shared.weight`` (a ``.safetensors`` stores a tied
    weight once), as ``encoder.embed_tokens.weight`` too (a ``.bin``) or in
    its place, and a T5ForConditionalGeneration's ``decoder.*`` and
    ``lm_head`` where given."""
    out = {k: v for k, v in t5.items() if shared or k != "shared.weight"}
    if embed_tokens or not shared:
        out["encoder.embed_tokens.weight"] = t5["shared.weight"]
    out.update(decoder or {})
    return out


def write_acestep_dir(root: Path, transformer: dict, dcae: dict, dcae_cfg, vocoder: dict,
                      umt5: dict, spm_model: bytes) -> dict:
    """ACE-Step's published directory in ``root``: ``ace_step_transformer/``
    (the transformer with its ``lyric_encoder.*``), ``music_dcae_f8c8/``
    (diffusers' ``config.json`` of ``dcae_cfg``, a ``models/dcae.DCAEConfig``,
    and the DCAE), ``music_vocoder/`` (ADaMoS), each as
    ``diffusion_pytorch_model.safetensors``, and ``umt5-base/``
    (``model.safetensors`` and ``spiece.model``).  Returns each file's bytes
    and write seconds."""
    import dataclasses

    config = {"_class_name": "AutoencoderDC", **dataclasses.asdict(dcae_cfg)}
    files = {"ace_step_transformer/diffusion_pytorch_model.safetensors": transformer,
             "music_dcae_f8c8/config.json": config,
             "music_dcae_f8c8/diffusion_pytorch_model.safetensors": dcae,
             "music_vocoder/diffusion_pytorch_model.safetensors": vocoder,
             "umt5-base/model.safetensors": umt5, "umt5-base/spiece.model": spm_model}
    out = {}
    for name, obj in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        if name.endswith(".safetensors"):
            write_safetensors(p, obj)
        elif name.endswith(".json"):
            p.write_text(json.dumps(obj))
        else:
            p.write_bytes(obj)
        out[name] = dict(bytes=p.stat().st_size, write_s=time.perf_counter() - t0)
    return out


def laion_clap_state(text: dict, audio: dict, seed: int, n_mels: int = 64, n_fft: int = 1024,
                     classes: int = 527) -> dict:
    """A laion_clap checkpoint of the two branches' state_dicts, ``module.``
    on every key, beside what neither package's loader reads (seeded
    values): ``logit_scale_a`` / ``logit_scale_t``, the text embeddings'
    ``position_ids``, HTSAT's STFT and log-mel extractors, its ``bn0`` over
    the mel bins and its TSCAM head."""
    import torch

    g = torch.Generator().manual_seed(seed)
    dim = audio["audio_branch.norm.weight"].shape[0]
    bins = n_fft // 2 + 1
    extra = {"logit_scale_a": torch.tensor(2.6592), "logit_scale_t": torch.tensor(2.6592),
             "text_branch.embeddings.position_ids": torch.arange(
                 text["text_branch.embeddings.position_embeddings.weight"].shape[0])[None],
             "audio_branch.spectrogram_extractor.stft.conv_real.weight":
                 torch.randn(bins, 1, n_fft, generator=g),
             "audio_branch.spectrogram_extractor.stft.conv_imag.weight":
                 torch.randn(bins, 1, n_fft, generator=g),
             "audio_branch.logmel_extractor.melW": torch.rand(bins, n_mels, generator=g),
             "audio_branch.bn0.weight": 1 + 0.1 * torch.randn(n_mels, generator=g),
             "audio_branch.bn0.bias": 0.1 * torch.randn(n_mels, generator=g),
             "audio_branch.bn0.running_mean": torch.randn(n_mels, generator=g),
             "audio_branch.bn0.running_var": 0.5 + torch.rand(n_mels, generator=g),
             "audio_branch.bn0.num_batches_tracked": torch.tensor(1000),
             "audio_branch.tscam_conv.weight": 0.01 * torch.randn(classes, dim, 2, 3, generator=g),
             "audio_branch.tscam_conv.bias": torch.zeros(classes),
             "audio_branch.head.weight": 0.01 * torch.randn(classes, dim, generator=g),
             "audio_branch.head.bias": torch.zeros(classes)}
    return {f"module.{k}": v for part in (text, audio, extra) for k, v in part.items()}


def vocos_file_state(vocos: dict, n_mels: int, seed: int) -> dict:
    """charactr/vocos' ``pytorch_model.bin`` of a state_dict ``vocos``, with
    the feature extractor's and the iSTFT head's buffers (window, mel
    filterbank) that neither package's loader reads."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n_fft = vocos["head.out.weight"].shape[0] - 2
    return {**vocos,
            "feature_extractor.mel_spec.spectrogram.window": torch.hann_window(n_fft),
            "feature_extractor.mel_spec.mel_scale.fb": torch.rand(n_fft // 2 + 1, n_mels,
                                                                  generator=g),
            "head.istft.window": torch.hann_window(n_fft)}


VOICE_OV_S = 10.0              # seconds of source audio OpenVoice converts from its file
VOICE_MERGES = ("t h", "e r", "i n", "th e", "o n", "a n")   # tokenizer.json's merges
ZONOS_OWN = ("text_emb.", "spk_proj.", "emotion.", "rate.", "pitch.")   # not in Zyphra's file


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (the process's flag
    restored after it)."""
    import torch

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def phase_loaders_voice(dev, card: str) -> dict:
    """The rest of the speech and cloning engines' checkpoint formats at full
    width, written here in the upstream layouts from seeded modules and read
    back by the port's loaders onto the card: each file's tensors equal to
    its twin's (the module in memory brought to what the loader should make
    of its file: weight-norm pairs and the GRU's r and z biases folded), with
    its bytes, write and load seconds.  (a) Zonos at ZonosConfig(mixer=
    "mamba2") (``build_tts``) as one ``model.safetensors``: the backbone,
    embeddings and heads under Zyphra's names beside a ``prefix_conditioner``
    bank, the published conditioner list with the ``mlp`` projection, whose
    specs are read back from a written ``config.json`` by
    ``zonos_prefix_specs_from_config``; the loaded model's own conditioning
    branches are the twin's (Zyphra's file has none), its mapped tensors NaN
    until loaded.  ``generate_embedded`` from the loaded bank's prefix pair
    (ZONOS_EMB_FRAMES frames, 2 fp32 K2) and ``ZonosTTS.synthesize`` with
    the DAC (2 fp32 K2).  (b) OpenVoice's ``converter.pth`` at
    ToneColorConfig() (``build_openvoice``), under ``model``, every
    weight-norm gain drawn off its weight's norm and the GRU's biases off
    their init: ``OpenVoiceCloner.convert`` of VOICE_OV_S s.  (c) A
    Chatterbox directory at the published widths (``build_chatterbox``; the
    voice encoder's LSTM biases and CAMPPlus's batch norms drawn off their
    init, HiFT's pairs with the gains off): ``t3_cfg.safetensors``,
    ``ve.safetensors``, ``s3gen.safetensors`` bundling ``flow.*``,
    ``mel2wav.*``, ``speaker_encoder.*`` and ``tokenizer.*``, a small
    ``tokenizer.json`` and a ``conds.pt`` made from the twin's conditioning
    on a CB_REF_S s reference, read by ``load_chatterbox_pipeline`` (each
    file's read seconds timed around the reader): ``synthesize`` from the
    builtin voice with the text through the loaded tokenizer, conditioning
    plus ``synthesize`` on the reference (both on cuDNN's deterministic
    algorithms: under its default ones HiFT's output differs run to run, and
    the twin's two runs under them print that spread), and T3's
    teacher-forced forward (30 fp32 K2).  Each run from the files and its twin's run get counts
    reset just before and read just after; launches must be equal and every
    output bit-equal.  Returns the path's launches: the runs from the
    files."""
    import copy
    import functools
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.models.phonemize import phonemize_ipa
    from audiolab_tpu_torch.models.zonos import (
        DEFAULT_ZONOS_CONDITIONERS,
        ZonosPrefixConditioner,
        generate_embedded,
        tokenize_phonemes_np,
    )
    from audiolab_tpu_torch.pipelines.cloning import OpenVoiceCloner
    from audiolab_tpu_torch.pipelines.tts import (
        ChatterboxCheckpointEngine,
        ChatterboxTokenizer,
        ZonosTTS,
        chatterbox_punc_norm,
    )
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    tag = "[loaders_voice]"
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_loaders_voice_"))
    files: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    path = dict.fromkeys(KERNELS, 0)
    through_file = functools.partial(load_through_file, dev, work, files, card, tag=tag)
    both = functools.partial(twin_run, dev, card, tag, runs, path, exact=True)

    def named(prefixes, modules):
        return {f"{pre}{k}": v for pre, m in zip(prefixes, modules)
                for k, v in m.state_dict().items()}

    def blank(module, keep=()):
        """A copy of ``module`` with every float tensor of its state NaN but
        those under ``keep``: what its loader must fill."""
        out = copy.deepcopy(module)
        with torch.no_grad():
            for k, t in out.state_dict().items():
                if t.is_floating_point() and not k.startswith(keep):
                    t.fill_(float("nan"))
        return out

    try:
        # (a) Zonos's model.safetensors: the backbone and the prefix bank
        tts = build_tts(dev, "mamba2")
        model = tts.model
        with torch.device(dev):
            bank = fast_init(ZonosPrefixConditioner(model.cfg.dim, DEFAULT_ZONOS_CONDITIONERS,
                                                    "mlp"), 5)
        (work / "config.json").write_text(json.dumps({"prefix_conditioner": {
            "conditioners": zonos_config_conditioners(DEFAULT_ZONOS_CONDITIONERS),
            "projection": "mlp"}}))
        pc = json.loads((work / "config.json").read_text())["prefix_conditioner"]
        specs = C.zonos_prefix_specs_from_config(pc["conditioners"])
        expect(specs == DEFAULT_ZONOS_CONDITIONERS,
               f"{tag} the conditioner specs read back from config.json differ: {specs}")
        ckpt = {k: v for k, v in cpu_state(model).items() if not k.startswith(ZONOS_OWN)}
        ckpt.update((f"prefix_conditioner.{k}", v) for k, v in cpu_state(bank).items())
        model_f = blank(model, keep=ZONOS_OWN)
        with torch.device(dev):
            bank_f = ZonosPrefixConditioner(model.cfg.dim, specs, pc["projection"])

        def load_zonos(p):
            sd = C.torch_load_weights(p)
            return C.load_zonos_state(model_f, sd), C.load_zonos_prefix_state(bank_f, sd)

        parts = ("model.", "bank.")
        through_file("Zonos ZonosConfig(mixer='mamba2') with its mlp prefix bank "
                     "(.safetensors)", "model.safetensors", ckpt, load_zonos,
                     named(parts, (model, bank)), write=write_safetensors,
                     state_of=lambda got: named(parts, got))
        del ckpt
        phon = torch.as_tensor(tokenize_phonemes_np([phonemize_ipa(TTS_TEXT)]), device=dev)
        gz = torch.Generator(device=dev).manual_seed(6)
        cond = dict(espeak=phon, speaker=torch.randn((1, 1, 128), generator=gz, device=dev),
                    emotion=torch.full((1, 1, 8), 0.1, device=dev),
                    fmax=torch.full((1, 1, 1), 22050.0, device=dev),
                    pitch_std=torch.full((1, 1, 1), 20.0, device=dev),
                    speaking_rate=torch.full((1, 1, 1), 15.0, device=dev),
                    language_id=torch.full((1, 1, 1), 24.0, device=dev))

        def embedded(m, b):
            def run():
                with torch.inference_mode():
                    x2 = torch.cat([b(cond), b({"espeak": phon})])
                return generate_embedded(m, x2, max_frames=ZONOS_EMB_FRAMES, seed=0, device=dev)
            return run

        both(f"Zonos generate_embedded from the loaded bank's prefix pair (phonemes "
             f"{phon.shape[1]}, {ZONOS_EMB_FRAMES} frames)", embedded(model_f, bank_f),
             embedded(model, bank), expect_k2=2)
        tts_f = ZonosTTS(model_f, tts.dac, tts.spk_enc, device=dev)
        both("ZonosTTS synthesize with the DAC (three sentences, CFG batch 6)",
             lambda: tts_f.synthesize(TTS_TEXT, seed=0)[0],
             lambda: tts.synthesize(TTS_TEXT, seed=0)[0], expect_k2=2)
        del tts, tts_f, model, model_f, bank, bank_f
        torch.cuda.empty_cache()

        # (b) OpenVoice's converter.pth
        ov = off_their_init(build_openvoice(dev).model, 231)
        pairs = gains_off(weight_norm_pairs(cpu_state(ov), OPENVOICE_WN), 232)
        want = C.fold_state_dict(pairs)
        C._fold_recurrent_biases(want, lstm=False)
        ov_mem = twin(ov, want)
        del ov, want
        ov_f = through_file("OpenVoice converter.pth (ToneColorConfig(), under model)",
                            "converter.pth", {"model": pairs},
                            lambda p: C.load_openvoice_checkpoint(p, device=dev), ov_mem)
        del pairs
        sr = ov_mem.cfg.sr
        src = _tone(VOICE_OV_S, sr)
        ref = _tone(CB_REF_S, CB_REF_SR)[::-1].copy()
        cl_f, cl_m = OpenVoiceCloner(ov_f, device=dev), OpenVoiceCloner(ov_mem, device=dev)
        both(f"OpenVoiceCloner convert ({VOICE_OV_S:g} s at {sr} Hz, a {CB_REF_S:g} s "
             f"reference)", lambda: cl_f.convert(src, sr, ref, CB_REF_SR)[0],
             lambda: cl_m.convert(src, sr, ref, CB_REF_SR)[0])
        del cl_f, cl_m, ov_f, ov_mem
        torch.cuda.empty_cache()

        # (c) the Chatterbox directory through load_chatterbox_pipeline
        t3, s3gen, ve, cp, st = build_chatterbox(dev)
        off_their_init(ve, 233)
        off_their_init(cp, 234)
        s3_pairs = gains_off(weight_norm_pairs(cpu_state(s3gen), HIFT_WN), 235)
        s3gen_mem = twin(s3gen, C.fold_state_dict(s3_pairs))
        del s3gen
        ref = _tone(CB_REF_S, CB_REF_SR) * (1 + 0.3 * np.sin(
            2 * np.pi * 3 * np.arange(int(CB_REF_S * CB_REF_SR)) / CB_REF_SR)).astype(np.float32)
        spk, rd = ChatterboxCheckpointEngine(t3, s3gen_mem, ve=ve, campplus=cp, s3tok=st,
                                             device=dev).conditioning(ref, CB_REF_SR)
        c = t3.cfg
        prompt = rd["ref_tokens"][:, :c.speech_cond_prompt_len]
        builtin = dict(speaker_emb=spk.reshape(-1), prompt_tokens=prompt.astype(np.int32),
                       ref_tokens=rd["ref_tokens"].astype(np.int32), ref_mel=rd["ref_mel"],
                       ref_xvector=rd["ref_xvector"].reshape(-1))
        d = work / "chatterbox"
        d.mkdir()
        written = write_chatterbox_dir(
            d, cpu_state(t3), cpu_state(ve), s3_pairs, cpu_state(cp), cpu_state(st),
            bpe_tokenizer_json(chatterbox_punc_norm(CB_TEXT), VOICE_MERGES),
            chatterbox_conds(spk, prompt, rd["ref_tokens"], rd["ref_mel"], rd["ref_xvector"]))
        del s3_pairs
        tok = ChatterboxTokenizer(str(d / "tokenizer.json"))
        reads: dict[str, float] = {}
        reader = C.torch_load_weights

        def timed_read(p):
            t0 = time.perf_counter()
            out = reader(p)
            reads[Path(p).name] = time.perf_counter() - t0
            return out

        C.torch_load_weights = timed_read
        try:
            t0 = time.perf_counter()
            eng_f = C.load_chatterbox_pipeline(str(d), device=dev)
            sync(dev)
            load_s = time.perf_counter() - t0
        finally:
            C.torch_load_weights = reader
        shutil.rmtree(d)
        label = "Chatterbox directory (t3_cfg, ve, s3gen with CAMPPlus and the S3 tokenizer)"
        mods = ("t3.", "ve.", "s3gen.", "campplus.", "s3tok.")
        own = named(mods, (eng_f.t3, eng_f.ve, eng_f.s3gen, eng_f.campplus, eng_f.s3tok))
        unequal, off = tensors_against(dev, tag, label, own,
                                       named(mods, (t3, ve, s3gen_mem, cp, st)))
        for name, f in written.items():
            f["read_s"] = reads.get(name, 0.0)
            log(f"{tag} Chatterbox {name}: {f['bytes'] / 2**20:.1f} MiB, written in "
                f"{f['write_s']:.3f} s, read in {f['read_s']:.3f} s | {card}")
        files[label] = dict(bytes=sum(f["bytes"] for f in written.values()),
                            write_s=sum(f["write_s"] for f in written.values()),
                            load_s=load_s, tensors=len(own), files=written)
        log(f"{tag} {label}: {files[label]['bytes'] / 2**20:.1f} MiB, written in "
            f"{files[label]['write_s']:.3f} s, load_chatterbox_pipeline onto {dev.type} in "
            f"{load_s:.3f} s; {len(own)} tensors, {len(unequal)} unequal, {len(off)} off "
            f"{dev.type} | {card}")
        expect(not unequal, f"{tag} {label}: tensors differ from the twins': {unequal[:8]}")
        expect(not off, f"{tag} {label}: tensors off {dev.type}: {off[:8]}")
        expect(set(eng_f.builtin) == set(builtin) and all(
            np.array_equal(eng_f.builtin[k], v) and eng_f.builtin[k].dtype == v.dtype
            for k, v in builtin.items()), f"{tag} conds.pt's builtin voice differs")
        norm = chatterbox_punc_norm(CB_TEXT)
        ids = list(eng_f.tokenize(norm))
        expect(ids == tok.encode(norm) and len(ids) < len(norm.encode()),
               f"{tag} the engine's text ids are not tokenizer.json's: {ids[:16]}")
        eng_m = ChatterboxCheckpointEngine(t3, s3gen_mem, ve=ve, tokenizer=tok.encode,
                                           builtin=builtin, campplus=cp, s3tok=st, device=dev)
        # cuDNN's default algorithms for HiFT's convolutions differ run to
        # run: the twin twice shows the spread, and the comparisons run on
        # cuDNN's deterministic algorithms
        twice = [eng_m.synthesize(CB_TEXT, max_tokens=CB_TOKENS, seed=3)[0] for _ in range(2)]
        spread = float(np.abs(twice[0].astype(np.float64) - twice[1]).max())
        runs["Chatterbox builtin synthesize, the twin twice"] = dict(
            max_abs_diff=spread, peak=float(np.abs(twice[0]).max()))
        log(f"{tag} Chatterbox synthesize from the builtin voice, the twin twice under "
            f"cuDNN's default algorithms: max|diff| {spread:.3e} of max|y| "
            f"{float(np.abs(twice[0]).max()):.4g} | {card}")
        with cudnn_deterministic():
            both(f"Chatterbox synthesize from conds.pt's builtin voice ({len(ids)} text ids, "
                 f"max_tokens {CB_TOKENS}; cuDNN deterministic)",
                 lambda: eng_f.synthesize(CB_TEXT, max_tokens=CB_TOKENS, seed=3)[0],
                 lambda: eng_m.synthesize(CB_TEXT, max_tokens=CB_TOKENS, seed=3)[0])
            both(f"Chatterbox conditioning on {CB_REF_S:g} s and synthesize (max_tokens "
                 f"{CB_TOKENS}; cuDNN deterministic)",
                 lambda: eng_f.synthesize(CB_TEXT, ref_wav=ref, ref_sr=CB_REF_SR,
                                          max_tokens=CB_TOKENS, seed=0)[0],
                 lambda: eng_m.synthesize(CB_TEXT, ref_wav=ref, ref_sr=CB_REF_SR,
                                          max_tokens=CB_TOKENS, seed=0)[0])
        text = torch.as_tensor([[c.start_text_token] + ids + [c.stop_text_token]], device=dev)
        gs = torch.Generator(device=dev).manual_seed(12)
        speech = torch.randint(0, eng_f.s3gen.flow_cfg.token_vocab, (1, 1 + CB_TOKENS),
                               generator=gs, device=dev)
        speech[:, 0] = c.start_speech_token
        spk_t = torch.as_tensor(spk, device=dev)[None]
        prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)
        emo = torch.full((1,), 0.5, device=dev)
        with torch.inference_mode():
            both(f"T3 teacher-forced forward ({text.shape[1]} text, {prompt.shape[1]} prompt, "
                 f"{speech.shape[1]} speech tokens)",
                 lambda: eng_f.t3(text, speech, spk_t, prompt_t, emo)[1],
                 lambda: t3(text, speech, spk_t, prompt_t, emo)[1], expect_k2=c.n_layers)
        del eng_f, eng_m, t3, s3gen_mem, ve, cp, st
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"{tag} {len(files)} files, {sum(f['bytes'] for f in files.values()) / 2**30:.2f} "
        f"GiB written in {sum(f['write_s'] for f in files.values()):.1f} s and loaded in "
        f"{sum(f['load_s'] for f in files.values()):.1f} s; the path's launches {path}; "
        f"phase {phase_s:.1f} s | {card}")
    expect(path["K2"] > 0 or not cuda, f"{tag} K2 was not launched on the path")
    return dict(launches=path, files=files, runs=runs, phase_s=phase_s)


VOCOS_MELS = 100               # charactr/vocos-mel-24khz's mel bins
MUSIC_VOCOS_FRAMES = 938       # 10 s of its frames (hop 256 at 24 kHz)


def phase_loaders_music(dev, card: str) -> dict:
    """The music models' checkpoint formats at the published widths, written
    here in the upstream layouts from fast_init modules (every weight-norm
    gain drawn off its weight's norm) and read back by the port's loaders
    onto the card: each file's tensors equal to its twin's (the module in
    memory brought to what the loader should make of its files: the Oobleck
    decoder's and ADaMoS's weight-norm pairs folded), with its bytes, write
    and read seconds.  (a) stable-audio-open (``random_stable_audio_checkpoint``:
    SAODiTConfig(), the Oobleck decoder, both seconds embedders, T5-base) as
    ``model.safetensors``, ``t5.safetensors`` and the SentencePiece model of
    ``music_spm_model``, read by ``load_stable_audio_pipeline``: ``generate``
    on MUSIC_SAO_S s at MUSIC_SAO_STEPS DPM++ 3M SDE steps, one fp32 K2 a
    layer a guided step.  (b) ACE-Step's published directory at the JAX
    widths (ACEStepDiTConfig() with the lyric conformer, DCAEConfig() with
    its ``config.json``, AdamosConfig(), UMT5-base with a SentencePiece
    model), read by ``load_acestep_pipeline``: ``generate`` on CKPT_S s at
    CKPT_STEPS steps from the prompt and MUSIC_LYRICS through the loaded text
    encoder (no kernel: linear self-attention, plain cross-attention).  (c)
    One laion_clap file (both branches at their defaults beside the logit
    scales, ``position_ids``, HTSAT's extractors, ``bn0`` and TSCAM head),
    read by ``load_clap_text_checkpoint`` and ``load_clap_audio_checkpoint``:
    the embeddings of two prompts and of a CLAP_S s clip.  (d) charactr/vocos'
    ``pytorch_model.bin`` at VocosConfig() over VOCOS_MELS mel bins, its
    configuration read from the file by ``load_vocos_checkpoint``: a decode
    of MUSIC_VOCOS_FRAMES frames.  Each family is written, loaded, compared
    and deleted before the next.  Where the twin's output differs run to run
    under cuDNN's default algorithms (two runs, the spread printed), the run
    from the files and the twin's are compared on the deterministic ones.
    Each run from the files and its twin's run get counts reset just before
    and read just after; launches must be equal and every output bit-equal.
    Returns the path's launches: the runs from the files."""
    import copy
    import functools
    import shutil
    import tempfile

    import torch

    from audiolab_tpu_torch.models.acestep import tokenize_lyrics
    from audiolab_tpu_torch.models.acestep_dit import (
        ACEStepDiT,
        ACEStepDiTConfig,
        LyricConformerEncoder,
    )
    from audiolab_tpu_torch.models.adamos_vocoder import AdamosConfig, AdamosVocoder
    from audiolab_tpu_torch.models.clap import (
        ClapAudioBranch,
        ClapAudioConfig,
        ClapTextBranch,
        ClapTextConfig,
        clap_mel_image,
    )
    from audiolab_tpu_torch.models.codecs import Vocos, VocosConfig
    from audiolab_tpu_torch.models.dcae import AutoencoderDC, DCAEConfig, spatial_compression
    from audiolab_tpu_torch.models.music_dcae import MusicDCAE, dcae_codec_fns
    from audiolab_tpu_torch.models.t5 import T5Encoder, umt5_base
    from audiolab_tpu_torch.pipelines.acestep import (
        ACEStepTextEncoder,
        CheckpointACEStep,
        checkpoint_pcfg,
    )
    from audiolab_tpu_torch.pipelines.music import (
        StableAudioCheckpointPipeline,
        random_stable_audio_checkpoint,
    )
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    cuda = dev.type == "cuda"
    tag = "[loaders_music]"
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_loaders_music_"))
    files: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    path = dict.fromkeys(KERNELS, 0)
    through_file = functools.partial(load_through_file, dev, work, files, card, tag=tag)
    both = functools.partial(twin_run, dev, card, tag, runs, path, exact=True)

    def named(prefixes, modules):
        return {f"{pre}{k}": v for pre, m in zip(prefixes, modules)
                for k, v in m.state_dict().items()}

    def inference(fn):
        def run():
            with torch.inference_mode():
                return fn()
        return run

    def as64(x):
        return (x.detach().double().cpu() if torch.is_tensor(x)
                else torch.from_numpy(np.asarray(x, np.float64)))

    def compared(label, from_file, in_memory, expect_k2=0):
        """``both`` on cuDNN's default algorithms where the twin repeats bit
        for bit on them (two runs, the spread recorded), else on the
        deterministic ones."""
        a, b = as64(in_memory()), as64(in_memory())
        spread, peak = float((a - b).abs().max()), float(b.abs().max())
        runs[f"{label}, the twin twice"] = dict(max_abs_diff=spread, peak=peak)
        log(f"{tag} {label}, the twin twice under cuDNN's default algorithms: max|diff| "
            f"{spread:.3e} of max|y| {peak:.4g} | {card}")
        if spread == 0.0:
            return both(label, from_file, in_memory, expect_k2=expect_k2)
        with cudnn_deterministic():
            return both(f"{label}; cuDNN deterministic", from_file, in_memory,
                        expect_k2=expect_k2)

    def timed_load(load, root: Path):
        """``load()`` with each ``torch_load_weights`` read timed: (what it
        returned, its seconds, {file under ``root``: read seconds})."""
        reads: dict[str, float] = {}
        reader = C.torch_load_weights

        def timed_read(p):
            t0 = time.perf_counter()
            out = reader(p)
            name = str(Path(p).relative_to(root))
            reads[name] = reads.get(name, 0.0) + time.perf_counter() - t0
            return out

        C.torch_load_weights = timed_read
        try:
            t0 = time.perf_counter()
            got = load()
            sync(dev)
            return got, time.perf_counter() - t0, reads
        finally:
            C.torch_load_weights = reader

    def write_timed(p: Path, obj) -> dict:
        t0 = time.perf_counter()
        if p.suffix == ".safetensors":
            write_safetensors(p, obj)
        else:
            torch.save(obj, p)
        return dict(bytes=p.stat().st_size, write_s=time.perf_counter() - t0)

    def loaded(label, written, load_s, reads, own, mine):
        """Record and print a multi-file load; every tensor equal to its
        twin's and on the card."""
        unequal, off = tensors_against(dev, tag, label, own, mine)
        for name, f in written.items():
            f["read_s"] = reads.get(name, 0.0)
            log(f"{tag} {label}: {name} {f['bytes'] / 2**20:.1f} MiB, written in "
                f"{f['write_s']:.3f} s, read in {f['read_s']:.3f} s | {card}")
        files[label] = dict(bytes=sum(f["bytes"] for f in written.values()),
                            write_s=sum(f["write_s"] for f in written.values()),
                            load_s=load_s, tensors=len(own), files=written)
        log(f"{tag} {label}: {files[label]['bytes'] / 2**20:.1f} MiB, written in "
            f"{files[label]['write_s']:.3f} s, loaded onto {dev.type} in {load_s:.3f} s; "
            f"{len(own)} tensors, {len(unequal)} unequal, {len(off)} off {dev.type} | {card}")
        expect(not unequal, f"{tag} {label}: tensors differ from the twins': {unequal[:8]}")
        expect(not off, f"{tag} {label}: tensors off {dev.type}: {off[:8]}")

    try:
        # (a) stable-audio-open: model.safetensors, T5-base, the SentencePiece model
        spm = music_spm_model(work / "spiece.model")
        sao = random_stable_audio_checkpoint(spm, device=dev)
        dec_pairs = gains_off(weight_norm_pairs(cpu_state(sao.decoder), OOBLECK_WN), 241)
        mem = StableAudioCheckpointPipeline(sao.dit, twin(sao.decoder, C.fold_state_dict(
            dec_pairs)), sao.t5, sao.ss, sao.st, spm, device=dev)
        del sao
        ckpt = stable_audio_state(cpu_state(mem.dit), dec_pairs, cpu_state(mem.ss),
                                  cpu_state(mem.st))
        written = {"model.safetensors": write_timed(work / "model.safetensors", ckpt)}
        del ckpt, dec_pairs
        written["t5.safetensors"] = write_timed(work / "t5.safetensors",
                                                t5_file_state(cpu_state(mem.t5)))
        sao_f, load_s, reads = timed_load(lambda: C.load_stable_audio_pipeline(
            str(work / "model.safetensors"), str(work / "t5.safetensors"), spm, device=dev),
            work)
        for name in written:
            (work / name).unlink()
        parts = ("dit.", "decoder.", "t5.", "seconds_start.", "seconds_total.")
        loaded("stable-audio-open (model.safetensors, T5-base)", written, load_s, reads,
               named(parts, (sao_f.dit, sao_f.decoder, sao_f.t5, sao_f.ss, sao_f.st)),
               named(parts, (mem.dit, mem.decoder, mem.t5, mem.ss, mem.st)))
        kw = dict(seconds_total=MUSIC_SAO_S, steps=MUSIC_SAO_STEPS, cfg_scale=7.0, seed=0)
        y = compared(f"stable-audio-open generate {MUSIC_SAO_S:g} s, {MUSIC_SAO_STEPS} DPM++ 3M "
                     f"SDE steps", lambda: sao_f.generate(MUSIC_PROMPT, **kw)[0],
                     lambda: mem.generate(MUSIC_PROMPT, **kw)[0],
                     expect_k2=MUSIC_SAO_STEPS * sao_f.dit_cfg.depth)
        t_lat = sao_f.latent_frames(MUSIC_SAO_S)
        expect(y.shape == (2, t_lat * 2048) and np.isfinite(y).all(),
               f"{tag} (a) output {y.shape}, finite {np.isfinite(y).all()}")
        del sao_f, mem, y
        torch.cuda.empty_cache() if cuda else None

        # (b) the checkpoint-layout ACE-Step's published directory
        with torch.device(dev):
            dit = fast_init(ACEStepDiT(ACEStepDiTConfig()), 242)
            lyr = fast_init(LyricConformerEncoder(), 243)
            t5 = fast_init(T5Encoder(umt5_base()), 244)
            dcae = fast_init(AutoencoderDC(DCAEConfig()), 245).eval()
            voc = fast_init(AdamosVocoder(AdamosConfig()), 246).eval()
        voc_pairs = gains_off(weight_norm_pairs(cpu_state(voc), ADAMOS_WN), 247)
        voc_mem = twin(voc, C.fold_state_dict(voc_pairs))
        del voc
        umt5_spm = music_spm_model(work / "umt5.model")
        transformer = cpu_state(dit)
        transformer.update((f"lyric_encoder.{k}", v) for k, v in cpu_state(lyr).items())
        d = work / "acestep"
        written = write_acestep_dir(d, transformer, cpu_state(dcae), DCAEConfig(), voc_pairs,
                                    t5_file_state(cpu_state(t5)), Path(umt5_spm).read_bytes())
        del transformer, voc_pairs
        ace_f, load_s, reads = timed_load(lambda: C.load_acestep_pipeline(str(d), device=dev), d)
        shutil.rmtree(d)
        pcfg = checkpoint_pcfg()
        pcfg.steps = CKPT_STEPS
        ace_f.pcfg = copy.copy(pcfg)
        ace_m = CheckpointACEStep(dit, lyr, pcfg=pcfg, decode_fn=MusicDCAE(
            *dcae_codec_fns(dcae), voc_mem).decode, text_encoder=ACEStepTextEncoder(
                t5, umt5_spm, device=dev), device=dev)
        parts = ("dit.", "lyric_encoder.", "umt5.", "dcae.", "vocoder.")
        codec = ace_f.decode_fn.__self__
        loaded("ACE-Step directory (transformer with the lyric encoder, DCAE, ADaMoS, UMT5)",
               written, load_s, reads,
               named(parts, (ace_f.model, ace_f.lyric_enc, ace_f.text_encoder.model,
                             codec.decoder_fn.model, codec.vocoder)),
               named(parts, (dit, lyr, t5, dcae, voc_mem)))
        ids = tokenize_lyrics(MUSIC_LYRICS, 128)
        ltoks = torch.from_numpy(ids[:int(np.count_nonzero(ids))].astype(np.int64))[None].to(dev)
        lmask = torch.ones_like(ltoks)
        speaker = torch.zeros(1, dit.cfg.speaker_embedding_dim, device=dev)

        def ace_generate(eng):
            def run():
                hidden, mask = eng.text_embeddings([MUSIC_PROMPT])
                null = eng.text_encoder.null_embeddings([MUSIC_PROMPT])
                return eng.generate(hidden, mask, speaker, ltoks, lmask, duration=CKPT_S,
                                    seed=0, text_hidden_null=null)
            return run

        y = compared(f"checkpoint ACE-Step generate {CKPT_S:g} s, {CKPT_STEPS} steps (the prompt "
                     f"through UMT5, {ltoks.shape[1]} lyric tokens)", ace_generate(ace_f),
                     ace_generate(ace_m))
        frames = int(round(CKPT_S * ace_f.latent_rate))
        hop = spatial_compression(dcae.cfg) * int(np.prod(voc_mem.cfg.upsample_rates))
        expect(y.shape == (1, 2, frames * hop) and np.isfinite(y).all(),
               f"{tag} (b) output {y.shape}, finite {np.isfinite(y).all()}")
        del ace_f, ace_m, codec, dit, lyr, t5, dcae, voc_mem, y
        torch.cuda.empty_cache() if cuda else None

        # (c) one laion_clap file, both branches
        with torch.device(dev):
            text_b = fast_init(ClapTextBranch(ClapTextConfig()), 248).eval()
            audio_b = fast_init(ClapAudioBranch(ClapAudioConfig()), 249).eval()
        name = "630k-audioset-best.pt"
        written = {name: write_timed(work / name, laion_clap_state(
            cpu_state(text_b), cpu_state(audio_b), 250))}
        p = str(work / name)
        (text_f, audio_f), load_s, reads = timed_load(lambda: (
            C.load_clap_text_checkpoint(p, device=dev, cfg=ClapTextConfig()),
            C.load_clap_audio_checkpoint(p, device=dev, cfg=ClapAudioConfig())), work)
        (work / name).unlink()
        parts = ("text.", "audio.")
        loaded("CLAP laion_clap checkpoint (both branches)", written, load_s, reads,
               named(parts, (text_f, audio_f)), named(parts, (text_b, audio_b)))
        g = torch.Generator().manual_seed(32)
        cfg = ClapTextConfig()
        tok = torch.randint(3, cfg.vocab_size, (2, 32), generator=g)
        tok[:, 0] = 0
        tok[1, 20:] = cfg.pad_id
        amask = (tok != cfg.pad_id).long().to(dev)
        tok = tok.to(dev)
        img = clap_mel_image(torch.from_numpy(lora_clip(CLAP_S, 48000, 7))[None].to(dev))
        for label, f, m, x in (("CLAP text embedding of two prompts", text_f, text_b,
                                (tok, amask)),
                               (f"CLAP audio embedding of a {CLAP_S:g} s clip", audio_f, audio_b,
                                (img,))):
            e = compared(label, inference(lambda f=f, x=x: f(*x)),
                         inference(lambda m=m, x=x: m(*x)))
            expect(tuple(e.shape) == (x[0].shape[0], 512), f"{tag} {label}: {tuple(e.shape)}")
        del text_b, audio_b, text_f, audio_f

        # (d) charactr/vocos' pytorch_model.bin
        with torch.device(dev):
            vocos = fast_init(Vocos(VocosConfig(), in_dim=VOCOS_MELS), 251).eval()
        vocos_f, vcfg = through_file(
            f"Vocos pytorch_model.bin (VocosConfig(), {VOCOS_MELS} mel bins)", "pytorch_model.bin",
            vocos_file_state(cpu_state(vocos), VOCOS_MELS, 252),
            lambda q: C.load_vocos_checkpoint(q, device=dev), vocos)
        expect(vcfg == VocosConfig(), f"{tag} Vocos's configuration read from the file: {vcfg}")
        mel = torch.randn(1, MUSIC_VOCOS_FRAMES, VOCOS_MELS, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(13))
        y = compared(f"Vocos decode of {MUSIC_VOCOS_FRAMES} frames",
                     inference(lambda: vocos_f(mel)), inference(lambda: vocos(mel)))
        expect(tuple(y.shape) == (1, (MUSIC_VOCOS_FRAMES - 1) * vcfg.hop),
               f"{tag} Vocos output {tuple(y.shape)}")
        del vocos, vocos_f, y
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"{tag} {len(files)} families, {sum(f['bytes'] for f in files.values()) / 2**30:.2f} "
        f"GiB written in {sum(f['write_s'] for f in files.values()):.1f} s and loaded in "
        f"{sum(f['load_s'] for f in files.values()):.1f} s; the path's launches {path}; "
        f"phase {phase_s:.1f} s | {card}")
    expect(path["K2"] > 0 or not cuda, f"{tag} K2 was not launched on the path")
    return dict(launches=path, files=files, runs=runs, phase_s=phase_s)


PAR_LENGTHS = (366, 300)      # frames of the two shards' rows: the 3.7 s slice, and 3.0 s
PAR_STEPS = 3                 # the cold step and two warm ones, each run
PAR_PROMPT = 512              # tokens of the tp forward's prompt
PAR_METRIC_TOL = 2 * 1e-4     # relative to the fp64 step, step 1 (twice train/check.py's GATE)
PAR_EXACT_TOL = 1e-5          # the fp64 dp step against the fp64 global step: gradients (of
                              # the gated max|g|) and metrics (relative); the mel loss's STFT
                              # runs in fp32 in both (kernels/stft.py), so they part at fp32's
                              # rounding there (1.4e-6 in a CPU rehearsal), far below a wrong
                              # reduction (a mean of the shards' KL ratios: percents)
PAR_LATER_TOL = 1e-2          # relative, the later steps (unpinned; Adam's near-zero elements)
PAR_TP_RATIO = 1.5            # the tp forward's distance from fp32, over the replicated one's
PAR_SEP_TOL = 1e-3            # of max|y|: the separator's stems, dp 2 against unsharded
PAR_EXPORT_TOL = 1e-5         # of max|y|: the exported synthesizer against eager infer
# the phase's sizes (a rehearsal on the CPU passes smaller ones): the
# synthesizer (None: v2-48k), phase train's batch, the shards' frames, the
# LM (None: YuE's stage 1), the prompt, the separator's members and track
PAR_SIZES = dict(synth_kw=None, batch=TRAIN_BATCH, samples=TRAIN_SAMPLES, lengths=PAR_LENGTHS,
                 lm_kw=None, prompt=PAR_PROMPT, sep_cfg=SEP_CFG, dur_s=DUR_S)


def par_configs(sizes: dict):
    """(the synthesizer's config, the LM's) of ``sizes``."""
    from audiolab_tpu_torch.models.lm import LMConfig
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerConfig, config_for
    from audiolab_tpu_torch.models.yue import YuEConfig

    synth = (SynthesizerConfig(**sizes["synth_kw"]) if sizes["synth_kw"]
             else config_for(48000, "v2"))
    lm = LMConfig(**sizes["lm_kw"]) if sizes["lm_kw"] else YuEConfig().stage1
    return synth, lm


def par_train_batch(dev, cfg, sizes: dict) -> dict:
    """Phase ``train``'s batch with unequal lengths: the first half of the
    rows (the first shard) 366 frames, the second half 300."""
    import torch

    b = sizes["batch"]
    batch = train_batch(dev, cfg, b, sizes["samples"])
    t = batch["spec"].shape[1]
    first, second = sizes["lengths"]
    lengths = torch.tensor([min(first, t)] * (b // 2) + [second] * (b // 2),
                           dtype=torch.long, device=dev)
    batch["phone_lengths"] = batch["spec_lengths"] = lengths
    return batch


def shard_pins(values: dict, index: int, count: int) -> dict:
    """A rank's rows of pins recorded on the whole batch: the batch is the
    first axis of every pin but the mel loss's STFT directions, stacked
    (re, im) in front of it."""
    from audiolab_tpu_torch.core.distributed import rows

    return {kind: [rows(v.transpose(0, 1), index, count).transpose(0, 1) if kind == "phasor"
                   else rows(v, index, count) for v in vs] for kind, vs in values.items()}


def _rvc_steps(dev, cfg, batch, step, pins=None, dtype=None, steps: int = PAR_STEPS,
               shards: int = 1) -> tuple:
    """``steps`` steps from seed 0's weights (in ``dtype``, fp32 by
    default); the first under ``pins`` (recorded when None, replayed when
    the recorded values are given).  ``batch`` is one of ``shards`` equal
    shards of the global batch (the draws are the global batch's).  Returns
    (state, the pins, each step's metrics, each step's seconds, the state
    after step 1: parameters and gradients on the CPU)."""
    from audiolab_tpu_torch.models.layers import Pins, pinned
    from audiolab_tpu_torch.models.rvc.synthesizer import TrainDraws
    from audiolab_tpu_torch.train.rvc import create_train_state, step_generator

    state, _, _ = create_train_state(cfg, seed=0, device=dev)
    draws = None
    if dtype is not None:
        # the draws step 1 takes by default, in the step's type
        state.gen.to(dtype)
        state.disc.to(dtype)
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        b, t = batch["spec"].shape[:2]
        d = TrainDraws.sample(cfg, b * shards, t, step_generator(0, 0, dev))
        draws = TrainDraws(d.posterior.to(dtype), d.starts, d.sine.to(dtype))
    record = pins is None
    if record:
        pins = Pins()
    else:
        rec, pins = pins, Pins()
        pins.values = rec
    losses, times, first = [], [], None
    for i in range(steps):
        ctx = pinned(pins, replay=not record) if i == 0 else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            state, metrics = step(state, batch, 0, draws=draws)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            first = {f"{m}.{k}": (p.detach().cpu().clone(), p.grad.detach().cpu().clone())
                     for m, net in (("gen", state.gen), ("disc", state.disc))
                     for k, p in net.named_parameters()}
    return state, pins, losses, times, first


def _allowed(ref: dict) -> dict:
    """Each gradient tensor's allowance against the fp64 step: its gated
    max|g| (train/check.py) times GATE, or times twice the single-process
    fp32 step's largest distance from fp64 over every tensor where that is
    larger.  An fp32 step of this batch sits that far from exact at its
    worst tensor, and which tensors a step's rounding lands on depends on
    how it splits its sums: the dp step and the single process's, each
    about 1.3e-3 of the gated max|g| away at their worst, on different
    text-encoder tensors (the fp64 dp step is the fp64 global step to
    within the fp32 STFT's rounding, :data:`PAR_EXACT_TOL`)."""
    from audiolab_tpu_torch.train.check import GATE, gated_scale

    peak = {k.split(".", 1)[1]: float(g.abs().max()) for k, g in ref["grads64"].items()}
    scale = {k: gated_scale(k.split(".", 1)[1], peak) or 1.0 for k in ref["grads64"]}
    worst = max(ref["err_single"][k] / scale[k] for k in scale)
    return {k: max(GATE, 2 * worst) * scale[k] for k in scale}


def _exactness(first64: dict, metrics64: dict, ref: dict) -> dict:
    """The fp64 dp step's step 1 against the fp64 single-process step's:
    the largest gradient difference over its tensor's gated max|g|, and the
    largest relative metric difference."""
    from audiolab_tpu_torch.train.check import gated_scale

    peak = {k.split(".", 1)[1]: float(g.abs().max()) for k, g in ref["grads64"].items()}
    errs = {k: float((g - ref["grads64"][k]).abs().max())
            / (gated_scale(k.split(".", 1)[1], peak) or 1.0) for k, (_, g) in first64.items()}
    at = max(errs, key=errs.get)
    return dict(grad_err=errs[at], grad_at=at,
                metric_err=max(abs(metrics64[k] - v) / abs(v)
                               for k, v in ref["metrics64"].items()))


def _against_reference(first: dict, ref: dict) -> dict:
    """Step 1's gradients against the fp64 single-process step's, each
    tensor's largest difference over its allowance (:func:`_allowed`; at
    most 1 passes), and the parameters against the fp32 single-process
    step's: the largest difference in units of lr, and the elements that
    moved differently by more than 1e-2 lr while their fp64 gradient is
    farther from 0 than the allowance (AdamW's first update is lr times the
    gradient's sign, so only a gradient within rounding of 0 may take the
    other sign)."""
    allowed = _allowed(ref)
    lr = ref["lr"]
    worst_g, at_g, worst_p, at_p, stray = 0.0, "", 0.0, "", 0
    for k, (p, g) in first.items():
        g64, (p32, _) = ref["grads64"][k], ref["first32"][k]
        eg = float((g.double() - g64).abs().max()) / allowed[k]
        if eg > worst_g:
            worst_g, at_g = eg, k
        dp = (p - p32).abs()
        ep = float(dp.max()) / lr
        if ep > worst_p:
            worst_p, at_p = ep, k
        stray += int(((dp > 1e-2 * lr) & (g64.abs() > allowed[k])).sum())
    return dict(grad_err=worst_g, grad_at=at_g, param_err_lr=worst_p, param_at=at_p,
                stray=stray)


def parallel_rank(rank: int, store: str, work: str, card: str, device: str,
                  sizes: dict) -> dict:
    """One of the two ranks sharing the card over gloo: (b) the
    data-parallel RVC step on this rank's shard against the single-process
    step the parent saved; (c) the LM core at YuE's stage-1 geometry under
    tp = 2 against its replicated and fp32 forwards, K2 launches counted
    just around the tp forward; (f) rank 0 traces a warm tp forward; (d)
    ``StemSeparator(mesh=get_mesh())`` on the chain's two members and the
    track, K1 launches counted around its first call, a second call timed,
    rank 0 saving the stems for the parent to hold against the unsharded
    separator."""
    import copy
    import dataclasses

    import torch
    import torch.distributed as dist

    from audiolab_tpu_torch.core.distributed import init_distributed, rank_device, rows
    from audiolab_tpu_torch.core.mesh import get_mesh
    from audiolab_tpu_torch.kernels import attention as A
    from audiolab_tpu_torch.models.lm import TransformerLM
    from audiolab_tpu_torch.parallel import shard_lm_params
    from audiolab_tpu_torch.pipelines.separate import StemSeparator
    from audiolab_tpu_torch.train.rvc import make_train_step
    from audiolab_tpu_torch.utils.fast_init import fast_init
    from audiolab_tpu_torch.utils.profiling import trace

    info = init_distributed(num_processes=2, process_id=rank, backend="gloo", device=device,
                            init_method=store, timeout=1200)
    dev = rank_device()
    out: dict = {"info": info, "device": str(dev)}

    # (b) the dp RVC step
    cfg, lm_cfg = par_configs(sizes)
    mesh = get_mesh()
    shard, dp = mesh.coordinate("dp"), mesh.shape["dp"]
    ref = torch.load(Path(work) / "single.pt", weights_only=False)
    batch = {k: rows(v, shard, dp) for k, v in par_train_batch(dev, cfg, sizes).items()}
    pins = shard_pins({k: [v.to(dev) for v in vs] for k, vs in ref["pins"].items()}, shard, dp)
    step = make_train_step(cfg, mesh=mesh)
    # step 1 in fp64: the dp decomposition against the fp64 global step
    _, _, losses64, _, first64 = _rvc_steps(dev, cfg, batch, step, pins, dtype=torch.float64,
                                            steps=1, shards=dp)
    exact = _exactness(first64, losses64[0], ref)
    del first64
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    state, replayed, losses, times, first = _rvc_steps(dev, cfg, batch, step, pins)
    out["rvc"] = dict(losses=losses, times=times, flips=replayed.flips, fp64=exact,
                      **_against_reference(first, ref))
    del state, batch, pins, ref, first
    torch.cuda.empty_cache()

    # (c) the tp = 2 LM forward at YuE's stage-1 geometry, bf16
    with torch.device(dev):
        lm = fast_init(TransformerLM(lm_cfg), 40).eval()
    toks = torch.randint(0, lm_cfg.vocab_size, (1, sizes["prompt"]), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    with torch.inference_mode():
        ref_logits, _ = lm(toks)
        with torch.device(dev):
            f32 = TransformerLM(dataclasses.replace(lm_cfg, dtype="float32")).eval()
        f32.load_state_dict({k: v.float() for k, v in lm.state_dict().items()})
        exact, _ = f32(toks)
        del f32
        tp_mesh = get_mesh(2)
        tp = shard_lm_params(copy.deepcopy(lm), tp_mesh)
        del lm
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        logits, _ = tp(toks)
        sync(dev)
        cold = time.perf_counter() - t0
        launches, hop = counts(), A.flash_attention_fwd.sm90_launches
        warm = []
        for i in range(3):
            t0 = time.perf_counter()
            if i == 2 and rank == 0:
                tdir = Path(work) / "trace"
                with trace(str(tdir)):
                    tp(toks)
                    sync(dev)
            else:
                tp(toks)
                sync(dev)
            warm.append(time.perf_counter() - t0)
    peak = float(exact.abs().max())
    out["tp"] = dict(
        launches=launches, hopper=hop, cold_s=cold, warm_s=warm,
        heads=(tp.model.layers[0].self_attn.n_heads, tp.model.layers[0].self_attn.n_kv_heads),
        err_replicated=float((logits.float() - ref_logits.float()).abs().max()),
        err_tp_fp32=float((logits.float() - exact).abs().max()),
        err_replicated_fp32=float((ref_logits.float() - exact).abs().max()), peak=peak,
        finite=bool(torch.isfinite(logits).all()))
    if rank == 0:
        names = set()
        for f in (Path(work) / "trace").glob("*.json"):
            names |= {e.get("name", "") for e in json.loads(f.read_text())["traceEvents"]}
        out["trace"] = dict(files=len(list((Path(work) / "trace").glob("*.json"))),
                            k2h=sorted(n for n in names if "k2h_kernel" in n)[:3])
    del tp, logits, ref_logits, exact
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the separator's fan-out over the two ranks
    sep = build_separator(dev, sizes["sep_cfg"])
    fan = StemSeparator(sep.members, sr=sep.sr, chunk_seconds=sep.chunk_seconds,
                        overlap_seconds=sep.overlap_seconds, device_batch=sep.device_batch,
                        mesh=mesh)
    audio = par_sep_audio(dev, sizes)
    reset_counts()
    t0 = time.perf_counter()
    got = fan.separate(audio, as_numpy=False)
    sync(dev)
    cold = time.perf_counter() - t0
    launches, k1h = counts(), A.attention_nk1.sm90_launches
    t0 = time.perf_counter()
    fan.separate(audio, as_numpy=False)
    sync(dev)
    out["separate"] = dict(launches=launches, hopper=k1h, cold_s=cold,
                           warm_s=time.perf_counter() - t0, device_batch=fan.device_batch)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in got.items()}, Path(work) / "fan.pt")
    dist.barrier()
    dist.destroy_process_group()
    return out


def par_sep_audio(dev, sizes: dict):
    """The fan-out's track: seeded stereo noise of ``sizes["dur_s"]``."""
    import torch

    return torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (2, int(sizes["dur_s"] * SEP_SR)))).astype(np.float32)).to(dev)


def speechlike(seed: int, sr: int = 16000, hop: int = 160) -> np.ndarray:
    """Two voiced stretches (a glide, a vibrato) of a harmonic sawtooth around
    an aspirated gap, under an envelope (tests/test_f0_world.py's signal)."""
    rng = np.random.default_rng(seed)
    seg1 = 130.0 * 2.0 ** (np.linspace(0.0, 0.4, 140) / 2.0)
    seg2 = 200.0 * 2.0 ** (0.4 * np.sin(2 * np.pi * np.arange(160) * hop / sr * 5.5) / 12.0)
    truth = np.concatenate([seg1, np.zeros(50), seg2])
    truth = truth * (1.0 + 0.003 * rng.standard_normal(len(truth)))
    per_sample = np.repeat(np.where(truth > 0, truth, 1.0), hop)
    phase = 2.0 * np.pi * np.cumsum(per_sample) / sr
    x = sum(np.sin(h * phase) / h for h in range(1, 9))
    x = x / np.abs(x).max()
    x[140 * hop:190 * hop] = 0.02 * rng.standard_normal(50 * hop)
    env = 0.4 + 0.6 * np.abs(np.sin(np.pi * np.arange(len(x)) / len(x)))
    return (x * env).astype(np.float64)


def wav_decode_ms(tmp: Path, native, read_wav, write_wav, seconds: float = DUR_S,
                  repeats: int = 5) -> dict:
    """``read_wav`` of a ``seconds`` stereo 44.1 kHz file (the chain's
    track) in each subtype, the native decoder against the numpy one: the
    median host milliseconds of ``repeats`` reads (the file in the page
    cache, warm)."""
    x = np.clip(0.4 * np.random.default_rng(1).standard_normal((2, int(seconds * SEP_SR))),
                -1, 1).astype(np.float32)
    out = {}
    saved = native.wav_decode
    for sub in ("PCM_16", "PCM_24", "FLOAT"):
        p = tmp / f"long_{sub}.wav"
        write_wav(p, x, SEP_SR, subtype=sub)
        for name in ("native", "numpy"):
            native.wav_decode = saved if name == "native" else (lambda data: None)
            try:
                times = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    read_wav(p)
                    times.append(time.perf_counter() - t0)
            finally:
                native.wav_decode = saved
            out[f"{sub}_{name}"] = float(np.median(times) * 1e3)
    return out


def phase_native(card: str) -> dict:
    """(g) The port's native library built where the script runs (g++ at
    first use), each function against its numpy counterpart."""
    import tempfile

    from audiolab_tpu_torch import native
    from audiolab_tpu_torch.core.audio_io import read_wav, write_wav
    from audiolab_tpu_torch.dsp.f0 import f0_dio, f0_harvest, stonemask
    from audiolab_tpu_torch.kernels.resample import resample_poly_np

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    expect(ok, f"native: the library did not build: {native.unavailable_reason()}")
    rec: dict = {"build_s": build_s, "library": str(native.library_path())}
    rng = np.random.default_rng(0)
    x = np.clip(0.4 * rng.standard_normal((2, 48000)), -1, 1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("PCM_16", "PCM_24", "FLOAT"):
            p = Path(tmp) / f"{sub}.wav"
            write_wav(p, x, 44100, subtype=sub)
            nat, sr = native.wav_decode(p.read_bytes())
            saved = native.wav_decode
            native.wav_decode = lambda data: None
            try:
                py = read_wav(p)
            finally:
                native.wav_decode = saved
            rec[f"decode_{sub}"] = bool(sr == py.sample_rate and np.array_equal(nat, py.samples))
        rec["decode_ms"] = wav_decode_ms(Path(tmp), native, read_wav, write_wav)
    data = native.wav_encode_pcm16(x, 44100)
    rt, _ = native.wav_decode(data)
    rec["encode_err"] = float(np.abs(rt - x).max())
    y = native.resample(x[0], 160, 441)
    ref = resample_poly_np(x[0], 44100, 16000)
    n = min(len(y), len(ref))
    rec["resample_len"], rec["resample_ref_len"] = len(y), len(ref)
    rec["resample_err"] = float(np.abs(y[50:n - 50] - ref[50:n - 50]).max())
    peak, rms = native.levels(x[0])
    rec["levels_err"] = max(abs(peak - float(np.abs(x[0]).max())),
                            abs(rms - float(np.sqrt(np.mean(x[0].astype(np.float64) ** 2)))))
    h = 1469598103934665603
    for byte in b"audiolab":
        h = ((h ^ byte) * 1099511628211) & (2 ** 64 - 1)
    rec["hash_ok"] = native.hash64(b"audiolab") == h
    sig = speechlike(0)
    for mode, fn in (("dio", f0_dio), ("harvest", f0_harvest)):
        est, orc = fn(sig, sr=16000, hop=160), native.world_f0(sig, 16000, 160, mode=mode)
        m = min(len(est), len(orc))
        est, orc = est[:m], orc[:m]
        both, either = (est > 0) & (orc > 0), (est > 0) | (orc > 0)
        rel = np.abs(est[both] - orc[both]) / orc[both]
        rec[f"{mode}_voicing"] = float(both.sum() / max(either.sum(), 1))
        rec[f"{mode}_median_rel"] = float(np.median(rel))
        rec[f"{mode}_p90_rel"] = float(np.percentile(rel, 90))
    sig = speechlike(3)
    raw = f0_dio(sig, sr=16000, hop=160, refine=False)
    py, cc = stonemask(sig, raw, sr=16000, hop=160), native.world_stonemask(sig, raw, 16000, 160)
    v = raw > 0
    rec["stonemask_median_rel"] = float(np.median(np.abs(py[v] - cc[v]) / np.maximum(cc[v], 1e-6)))
    log(f"[parallel] (g) native library built in {build_s:.2f} s ({rec['library']}): WAV decode "
        f"bit-equal to numpy PCM16 {rec['decode_PCM_16']} PCM24 {rec['decode_PCM_24']} float "
        f"{rec['decode_FLOAT']}; read_wav of {DUR_S:.0f} s stereo, native / numpy ms "
        + ", ".join(f"{sub} {rec['decode_ms'][sub + '_native']:.2f} / "
                    f"{rec['decode_ms'][sub + '_numpy']:.2f}"
                    for sub in ("PCM_16", "PCM_24", "FLOAT"))
        + f" (warm, median of 5); PCM16 round trip {rec['encode_err']:.2e}; resample 44.1 -> 16 "
        f"kHz {rec['resample_len']} / {rec['resample_ref_len']} samples, interior "
        f"{rec['resample_err']:.3e} from resample_poly_np; levels {rec['levels_err']:.2e}; "
        f"hash64 {rec['hash_ok']}; WORLD oracle against dsp/f0.py: dio voicing "
        f"{rec['dio_voicing']:.3f} median {rec['dio_median_rel']:.4f} p90 "
        f"{rec['dio_p90_rel']:.4f}, harvest {rec['harvest_voicing']:.3f} / "
        f"{rec['harvest_median_rel']:.4f} / {rec['harvest_p90_rel']:.4f}, stonemask median "
        f"{rec['stonemask_median_rel']:.5f} | {card}")
    expect(all(rec[f"decode_{s}"] for s in ("PCM_16", "PCM_24", "FLOAT")),
           "native: WAV decode differs from numpy")
    expect(rec["encode_err"] < 1e-4 and rec["resample_len"] == rec["resample_ref_len"]
           and rec["resample_err"] < 5e-2 and rec["levels_err"] < 1e-6 and rec["hash_ok"],
           f"native: {rec}")
    expect(all(rec[f"{m}_voicing"] > 0.75 and rec[f"{m}_median_rel"] < 0.02
               and rec[f"{m}_p90_rel"] < 0.08 for m in ("dio", "harvest"))
           and rec["stonemask_median_rel"] < 0.01, f"native: WORLD oracle {rec}")
    return rec


def phase_parallel(dev, card: str, sizes: dict | None = None) -> dict:
    """The parallel layer and the host utilities on the card.  (a)
    ``init_distributed`` as one NCCL rank and an ``all_reduce``; (b) the RVC
    GAN step at v2-48k, phase ``train``'s batch of 8 split 4 + 4 over two
    ranks sharing the card over gloo, the shards' lengths 366 and 300
    frames, against the single-process step on the same weights, batch and
    draws (step 1's pins recorded by the single process, each rank
    replaying its rows): step 1's metrics and gradients, the parameters
    after it, later steps' metrics, seconds a step for both; (c) the LM core
    at YuE's stage-1 geometry (2048 x 16 layers, 16 heads x 128, bf16)
    under tp = 2 on a 512-token prompt in the same two ranks, against the
    replicated forward and an fp32 one, the 16-bit K2 launches of each
    rank's tp forward; (d) ``StemSeparator(mesh=get_mesh())`` with dp = 2
    in the same two ranks on the chain's two members and the 60 s track
    against the unsharded separator, K1 launches counted; (e)
    ``export_rvc_synthesizer`` at v2-48k on the card, the loaded program
    against eager ``infer``; (f) ``profiling.trace`` around a warm tp
    forward of (c) on rank 0, the written trace naming ``k2h_kernel``; (g)
    the native library built where the script runs, each function against
    its numpy counterpart; (h) ``dryrun_multichip(2, backend="gloo")``.  Returns the
    path's launches: K1 of (d) and the two ranks' K2 of (c).

    ``sizes`` (default :data:`PAR_SIZES`): a rehearsal on the CPU passes
    small ones; there (a) starts one gloo rank and the launch checks are
    skipped."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from audiolab_tpu_torch.core.distributed import init_distributed, run_ranks
    from audiolab_tpu_torch.dryrun import dryrun_multichip
    from audiolab_tpu_torch.models.rvc.synthesizer import SynthesizerTrn
    from audiolab_tpu_torch.train.check import GATE, gated_scale
    from audiolab_tpu_torch.train.rvc import make_train_step
    from audiolab_tpu_torch.utils.export import export_rvc_synthesizer, load_program
    from audiolab_tpu_torch.utils.fast_init import fast_init

    sizes = sizes or PAR_SIZES
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    rec: dict = {}
    path = dict.fromkeys(KERNELS, 0)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        # (a) one NCCL rank
        t0 = time.perf_counter()
        info = init_distributed(num_processes=1, process_id=0, device=dev.type,
                                init_method=f"file://{work}/nccl_store", timeout=300)
        x = torch.full((4,), 2.0, device=dev)
        dist.all_reduce(x)
        backend = dist.get_backend()
        dist.destroy_process_group()
        rec["nccl"] = dict(info=info, backend=backend, s=time.perf_counter() - t0)
        log(f"[parallel] (a) init_distributed as one rank: {info}, backend {backend}, "
            f"all_reduce {x.tolist()} in {rec['nccl']['s']:.2f} s | {card}")
        expect(backend == ("nccl" if cuda else "gloo")
               and info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                            "global_devices": 1}
               and x.tolist() == [2.0] * 4, "parallel (a): the NCCL rank")

        # (b) the fp64 step records step 1's pins; the single-process fp32
        # steps replay them; both steps' step 1 saved for the ranks
        cfg, lm_cfg = par_configs(sizes)
        batch = par_train_batch(dev, cfg, sizes)
        step = make_train_step(cfg)
        _, pins, losses64, times64, first64 = _rvc_steps(dev, cfg, batch, step,
                                                         dtype=torch.float64, steps=1)
        state, replayed, losses, times, first = _rvc_steps(dev, cfg, batch, step,
                                                           pins=pins.values)
        ref = {"pins": {k: [v.cpu() for v in vs] for k, vs in pins.values.items()},
               "grads64": {k: g for k, (_, g) in first64.items()}, "first32": first,
               "err_single": {k: float((first[k][1].double() - g).abs().max())
                              for k, (_, g) in first64.items()},
               "metrics64": losses64[0], "lr": state.g_opt.base_lr}
        peak = {k.split(".", 1)[1]: float(g.abs().max()) for k, g in ref["grads64"].items()}
        own = max(e / (GATE * gated_scale(k.split(".", 1)[1], peak))
                  for k, e in ref["err_single"].items())
        single_metric = max(abs(losses[0][k] - v) / abs(v) for k, v in losses64[0].items())
        torch.save(ref, work / "single.pt")
        single = dict(losses=losses, times=times, fp64_s=times64[0], flips=replayed.flips,
                      metric_err=single_metric)
        log(f"[parallel] (b) single process, batch {sizes['batch']}: the fp64 step in "
            f"{times64[0]:.2f} s records step 1's pins; the fp32 step replays them "
            f"({replayed.flips} leaky ReLU inputs on the other side): metrics "
            f"{single_metric:.3e} relative from fp64, gradients at most {own:.3f} GATE of "
            f"the gated max|g| (twice that is the ranks' allowance where it passes GATE) "
            f"| {card}")
        del state, pins, first, first64, batch, ref
        if cuda:
            torch.cuda.empty_cache()

        # (b), (c), (f), (d): two ranks sharing the card over gloo
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, 2, (f"file://{work}/gloo_store", str(work), card,
                                             dev.type, sizes), timeout=900)
        ranks_s = time.perf_counter() - t0
        for r, out in enumerate(ranks):
            b = out["rvc"]
            m_err = max(abs(b["losses"][0][k] - v) / abs(v) for k, v in losses64[0].items())
            later = max(abs(b["losses"][i][k] - v) / abs(v) for i in range(1, PAR_STEPS)
                        for k, v in losses[i].items())
            b.update(metric_err=m_err, later_err=later)
            e64 = b["fp64"]
            log(f"[parallel] (b) rank {r}: the dp step 1 in fp64 against the global fp64 step: "
                f"gradients {e64['grad_err']:.3e} of the gated max|g| (at {e64['grad_at']}), "
                f"metrics {e64['metric_err']:.3e} relative (tolerance {PAR_EXACT_TOL:g}) | {card}")
            expect(e64["grad_err"] <= PAR_EXACT_TOL and e64["metric_err"] <= PAR_EXACT_TOL,
                   f"parallel (b): rank {r}'s fp64 dp step is not the global step")
            log(f"[parallel] (b) rank {r} ({out['device']}, {out['info']}): dp step, batch "
                f"{sizes['batch'] // 2} of the global {sizes['batch']} (lengths "
                f"{sizes['lengths'][r]}), step 1 replaying its rows of the fp64 step's "
                f"pins ({b['flips']} leaky ReLU inputs on the other side): metrics "
                f"{m_err:.3e} relative from the fp64 step (tolerance {PAR_METRIC_TOL:g}), "
                f"gradients at most {b['grad_err']:.3f} of their allowance (at {b['grad_at']}; "
                f"the larger of GATE and twice the single process's largest fp32 distance, of "
                f"the gated max|g|), parameters {b['param_err_lr']:.3f} lr from the "
                f"single process's at {b['param_at']} ({b['stray']} elements moved "
                f"differently with a gradient off 0), steps 2-{PAR_STEPS} metrics "
                f"{later:.3e} from the single process's (tolerance "
                f"{PAR_LATER_TOL:g}); seconds a step: cold {b['times'][0]:.3f}, warm "
                + " / ".join(f"{t:.3f}" for t in b["times"][1:]) + f" | {card}")
            expect(m_err <= PAR_METRIC_TOL and b["grad_err"] <= 1.0
                   and b["param_err_lr"] <= 2.0 * (1 + 1e-3) and b["stray"] == 0
                   and later <= PAR_LATER_TOL, f"parallel (b): rank {r} against the single "
                   "process")
        log(f"[parallel] (b) single process, batch {sizes['batch']}: cold "
            f"{single['times'][0]:.3f} s, warm "
            + " / ".join(f"{t:.3f}" for t in single["times"][1:]) + f" s a step; the two "
            f"ranks' warm median {np.median(ranks[0]['rvc']['times'][1:]):.3f} / "
            f"{np.median(ranks[1]['rvc']['times'][1:]):.3f} s (gloo, one card); the ranks' "
            f"call {ranks_s:.1f} s | {card}")
        rec["rvc"] = dict(single=single, ranks=[o["rvc"] for o in ranks], ranks_s=ranks_s)
        for r, out in enumerate(ranks):
            c = out["tp"]
            ratio = c["err_tp_fp32"] / max(c["err_replicated_fp32"], 1e-30)
            log(f"[parallel] (c) rank {r}: LM {lm_cfg.dim} x {lm_cfg.n_layers}, "
                f"{lm_cfg.dtype}, under tp 2, {c['heads'][0]} of {lm_cfg.n_heads} heads a rank, "
                f"{sizes['prompt']}-token prompt: logits "
                f"max|diff| from the replicated forward {c['err_replicated']:.4e}, from fp32 "
                f"{c['err_tp_fp32']:.4e} against the replicated forward's {c['err_replicated_fp32']:.4e} "
                f"(ratio {ratio:.3f}, tolerance {PAR_TP_RATIO}; max|logits| {c['peak']:.3f}); "
                f"launches {c['launches']} ({c['hopper']} K2 on the Hopper route); cold "
                f"{c['cold_s']:.3f} s, warm " + " / ".join(f"{t * 1e3:.1f} ms" for t in c["warm_s"])
                + f" | {card}")
            expect(c["finite"] and c["heads"] == (lm_cfg.n_heads // 2, lm_cfg.n_kv_heads // 2)
                   and ratio <= PAR_TP_RATIO, f"parallel (c): rank {r}")
            if cuda:
                expect(only(c["launches"], "K2", lm_cfg.n_layers)
                       and c["hopper"] == lm_cfg.n_layers,
                       f"parallel (c): rank {r}'s launches {c['launches']}")
            for k in KERNELS:
                path[k] += c["launches"][k]
        rec["tp"] = [o["tp"] for o in ranks]
        tr = ranks[0]["trace"]
        log(f"[parallel] (f) profiling.trace around rank 0's warm tp forward: {tr['files']} "
            f"trace file(s), kernels named k2h_kernel: {tr['k2h']} | {card}")
        expect(tr["files"] >= 1 and (tr["k2h"] or not cuda),
               "parallel (f): the trace names no k2h_kernel")
        rec["trace"] = tr

        # (d) the separator's fan-out over the two ranks, against the
        # unsharded separator on the same track (its second call timed)
        sep = build_separator(dev, sizes["sep_cfg"])
        audio = par_sep_audio(dev, sizes)
        phase_separator(dev, sep, audio, 48 if cuda else None)
        want, _, plain_s = phase_separator(dev, sep, audio, 48 if cuda else None)
        got = torch.load(work / "fan.pt", weights_only=True)
        err = max(float((got[k] - want[k].cpu()).abs().max()) for k in want)
        peak = max(float(v.abs().max()) for v in want.values())
        fans = [o["separate"] for o in ranks]
        log(f"[parallel] (d) StemSeparator(mesh=get_mesh()) over two ranks sharing the card "
            f"(gloo), {sizes['dur_s']:.0f} s: device batch {fans[0]['device_batch']} split in "
            f"two; rank 0's stems max|diff| from the unsharded separator {err:.3e} (tolerance "
            f"{PAR_SEP_TOL * peak:.3e}: {PAR_SEP_TOL:g} of max|y|); cold "
            + " / ".join(f"{f['cold_s']:.3f}" for f in fans) + " s, warm "
            + " / ".join(f"{f['warm_s']:.3f}" for f in fans) + f" s against the unsharded "
            f"{plain_s:.3f} s; launches a rank {[f['launches'] for f in fans]} "
            f"({[f['hopper'] for f in fans]} K1 on the Hopper routes) | {card}")
        expect(set(got) == set(want) and err <= PAR_SEP_TOL * peak, "parallel (d): stems")
        for r, f in enumerate(fans):
            if cuda:
                expect(only(f["launches"], "K1", 48) and f["hopper"] == 48,
                       f"parallel (d): rank {r}'s launches {f['launches']}")
            for k in KERNELS:
                path[k] += f["launches"][k]
        rec["separate"] = dict(err=err, peak=peak, ranks=fans, plain_s=plain_s)
        del sep, audio, got, want
        if cuda:
            torch.cuda.empty_cache()

        # (e) the exported synthesizer
        with torch.device(dev):
            synth = fast_init(SynthesizerTrn(cfg), 0).eval()
        t0 = time.perf_counter()
        export_rvc_synthesizer(synth, cfg, str(work / "rvc.pt2"), frames=100, device=dev)
        export_s = time.perf_counter() - t0
        program = load_program(str(work / "rvc.pt2"))
        g = np.random.default_rng(1)
        args = (torch.from_numpy(g.standard_normal((1, 100, cfg.feat_channels)).astype(
                    np.float32)).to(dev),
                torch.full((1,), 100, dtype=torch.long, device=dev),
                torch.from_numpy(g.integers(1, 255, (1, 100))).to(dev),
                torch.from_numpy(g.uniform(100, 400, (1, 100)).astype(np.float32)).to(dev),
                torch.zeros(1, dtype=torch.long, device=dev))
        with torch.no_grad():
            y = program(*args)
            eager = [synth.infer(*args, None) for _ in range(3)]
        ref = eager[0]
        # eager infer itself differs run to run on the card (about 7e-9 of
        # max|y| 8e-4 in a diagnostic call, under either cuDNN setting)
        spread = max(float((a - b).abs().max()) for a in eager for b in eager)
        err = float((y - ref).abs().max())
        peak = float(ref.abs().max())
        tol = max(PAR_EXPORT_TOL * peak, 2 * spread)
        log(f"[parallel] (e) export_rvc_synthesizer, 100 frames, on {dev.type}: exported "
            f"and saved in {export_s:.1f} s ({(work / 'rvc.pt2').stat().st_size / 2**20:.1f} "
            f"MiB); eager infer three times: max|diff| {spread:.3e}; the loaded program "
            f"against eager infer: bit-equal {torch.equal(y, ref)}, max|diff| {err:.3e} "
            f"(tolerance {tol:.3e}: {PAR_EXPORT_TOL:g} of max|y| {peak:.3e}, or twice eager's "
            f"spread) | {card}")
        expect(tuple(y.shape) == tuple(ref.shape) == (1, 100 * cfg.upp) and err <= tol,
               "parallel (e): the exported program")
        rec["export"] = dict(err=err, peak=peak, export_s=export_s, spread=spread)
        del synth, program
        if cuda:
            torch.cuda.empty_cache()

        # (g) the native library
        rec["native"] = phase_native(card)

        # (h) the dry run, two ranks sharing the card over gloo
        t0 = time.perf_counter()
        dry = dryrun_multichip(2, device=dev.type, backend="gloo")
        dry_s = time.perf_counter() - t0
        log(f"[parallel] (h) dryrun_multichip(2, backend='gloo') in {dry_s:.1f} s: ranks on "
            f"{[d['device'] for d in dry]}, RVC metrics equal on both "
            f"{dry[0]['rvc'] == dry[1]['rvc']}, tp forward {[d['tp_err'] for d in dry]} from "
            f"the replicated one, separation {[d['sep_err'] for d in dry]} from the unsharded "
            f"one, Zonos codes {len(dry[0]['zonos'])} rows | {card}")
        expect(dry[0]["rvc"] == dry[1]["rvc"] and dry[0]["zonos"] == dry[1]["zonos"],
               "parallel (h): the ranks disagree")
        rec["dryrun_s"] = dry_s
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[parallel] launches on the path: {path}; phase {rec['phase_s']:.1f} s | {card}")
    rec["launches"] = path
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", default=None, help="directory for a profiler table")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2

    from audiolab_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    t_run = t0 = time.perf_counter()

    def mark(phase: str) -> None:
        log(f"[card] phase {phase} starts at {time.perf_counter() - t_run:.1f} s")

    libs = _build.build(["attention", "norms"])
    build_s = time.perf_counter() - t0
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| kernel build {build_s:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log")
        if report.exists():
            log(f"[card] ptxas {name}: {ptxas_summary(report.read_text())} ({report})")
            check_new_kernels(report.read_text())

    kernel_recs: list[dict] = []
    if "kernels" in phases:
        mark("kernels")
        kernel_recs = phase_kernels(dev, card)

    main_launches = dict.fromkeys(KERNELS, 0)
    served = family = trained = spoken = processed = engines = chatter = heard = None
    diffused = composed = adapted = sung = loaded = listened = spoken_files = None
    voiced_files = music_files = paralleled = None
    need_chain = {"separator", "rvc", "fidelity", "f0", "reference", "timing", "vr",
                  "serve", "separators", "processors", "loaders", "long"} & set(phases)
    if need_chain:
        mark("separator")
        t0 = time.perf_counter()
        sep = build_separator(dev)
        vcs = build_rvc(dev)
        sync(dev)
        log(f"[card] models built on the card in {time.perf_counter() - t0:.1f} s")
        audio = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
            (2, int(DUR_S * SEP_SR)))).astype(np.float32)).to(dev)
        stems, launches, _ = phase_separator(dev, sep, audio)
        for k in main_launches:
            main_launches[k] += launches[k]
        x16, out, launches, _ = phase_rvc(dev, vcs["bfloat16"], stems["vocals"])
        for k in main_launches:
            main_launches[k] += launches[k]
        if "fidelity" in phases:
            mark("fidelity")
            phase_fidelity(dev, vcs, x16, out)
        if "f0" in phases:
            mark("f0")
            phase_f0(dev, vcs["bfloat16"], stems["vocals"])
        if "vr" in phases:
            mark("vr")
            phase_vr(dev, stems["vocals"])
        del stems, x16, out
        if "reference" in phases:
            mark("reference")
            phase_reference(dev, sep, vcs)
        if "timing" in phases:
            mark("timing")
            phase_timing(dev, sep, vcs["bfloat16"], audio, card, args.profile)
        if "serve" in phases:
            mark("serve")
            served = phase_serve(dev, sep, vcs["bfloat16"], audio, card)["served_launches"][0]
        if "separators" in phases:
            mark("separators")
            family = phase_separators(dev, sep, audio, card,
                                      profile_dir=args.profile)["ensemble_launches"]
        if "processors" in phases:
            mark("processors")
            processed = phase_processors(dev, sep, vcs["bfloat16"], audio,
                                         card)["served_launches"]
        if "loaders" in phases:
            mark("loaders")
            # this slice's path: the chain built from the loaded files, counts
            # reset just before it and read just after
            loaded = phase_loaders(dev, sep, vcs["bfloat16"], audio, card)["launches"]
        if "long" in phases:
            mark("long")
            del audio
            torch.cuda.empty_cache()
            phase_long(dev, sep, vcs["bfloat16"], card)
        del sep, vcs
        torch.cuda.empty_cache()
    if "train" in phases:
        mark("train")
        trained = phase_train(dev, card)["train_launches"]
    if "tts" in phases:
        mark("tts")
        # this slice's path: one synthesize call, counts reset just before it
        # and read just after (the first mamba1 call)
        spoken = phase_tts(dev, card, profile_dir=args.profile)["launches"]
    if "engines" in phases:
        mark("engines")
        # this slice's path: Dia's first synthesize and the LM's uncached
        # forward, counts reset just before each and read just after
        engines = phase_engines(dev, card, profile_dir=args.profile)["launches"]
    if "chatterbox" in phases:
        mark("chatterbox")
        # this slice's path: T3's teacher-forced forward, counts reset just
        # before and read just after (Chatterbox's generation launches none)
        chatter = phase_chatterbox(dev, card, profile_dir=args.profile)["launches"]
    if "transcribe" in phases:
        mark("transcribe")
        # this slice's path: Whisper's uncached forward and the aligner's
        # first call of each span, counts reset just before each and read
        # just after (the decode and the VAD launch none)
        heard = phase_transcribe(dev, card)["launches"]
    if "diffusion" in phases:
        mark("diffusion")
        # this slice's path: every step of the phase, counts reset just
        # before each and read just after (it launches none of K1-K7)
        diffused = phase_diffusion(dev, card, profile_dir=args.profile)["launches"]
    if "music" in phases:
        mark("music")
        # this slice's path: the cold generate of each music pipeline,
        # ACE-Step's repaint and the two served calls, counts reset just
        # before each and read just after
        composed = phase_music(dev, card)["launches"]
    if "lora" in phases:
        mark("lora")
        # this slice's path: the first training run, the gradient checks'
        # kernel runs and the three served calls, counts reset just before
        # each and read just after
        adapted = phase_lora(dev, card)["launches"]
    if "yue" in phases:
        mark("yue")
        # this slice's path: the full-width generate_music's cold call and
        # the served request, counts reset just before each and read just
        # after (YuE launches none of K1-K7)
        sung = phase_yue(dev, card, profile_dir=args.profile)["launches"]
    if "loaders_listen" in phases:
        mark("loaders_listen")
        # this slice's path: each model loaded from its file, counts reset just
        # before each run and read just after (Whisper's uncached forward and
        # the aligner's spans launch K2; AudioSR, the diarizer and RTLA none)
        listened = phase_loaders_listen(dev, card)["launches"]
    if "loaders_speech" in phases:
        mark("loaders_speech")
        # this slice's path: each engine loaded from its files, counts reset
        # just before each run and read just after (Dia's call and the
        # Dia-1.6B forward launch K2; XTTS-v2 and the DVAE none)
        spoken_files = phase_loaders_speech(dev, card)["launches"]
    if "loaders_voice" in phases:
        mark("loaders_voice")
        # this slice's path: each engine loaded from its files, counts reset
        # just before each run and read just after (Zonos's two calls and
        # T3's forward launch K2; OpenVoice and Chatterbox's synthesize none)
        voiced_files = phase_loaders_voice(dev, card)["launches"]
    if "loaders_music" in phases:
        mark("loaders_music")
        # this slice's path: each model loaded from its files, counts reset
        # just before each run and read just after (stable-audio-open's
        # generate launches the fp32 K2; ACE-Step, CLAP and Vocos none)
        music_files = phase_loaders_music(dev, card)["launches"]
    if "parallel" in phases:
        mark("parallel")
        # this slice's path: the separator's dp fan-out and each rank's tp
        # forward of the LM core, counts reset just before each and read
        # just after (the dp RVC step launches none)
        paralleled = phase_parallel(dev, card)["launches"]

    log(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"launches": main_launches[r["kernel"]], "case": r["case"],
           "served_launches": None if served is None else served[r["kernel"]],
           "separators_launches": None if family is None else family[r["kernel"]],
           "train_launches": None if trained is None else trained[r["kernel"]],
           "tts_launches": None if spoken is None else spoken[r["kernel"]],
           "processors_launches": None if processed is None else processed[r["kernel"]],
           "engines_launches": None if engines is None else engines[r["kernel"]],
           "chatterbox_launches": None if chatter is None else chatter[r["kernel"]],
           "transcribe_launches": None if heard is None else heard[r["kernel"]],
           "diffusion_launches": None if diffused is None else diffused[r["kernel"]],
           "music_launches": None if composed is None else composed[r["kernel"]],
           "lora_launches": None if adapted is None else adapted[r["kernel"]],
           "yue_launches": None if sung is None else sung[r["kernel"]],
           "loaders_launches": None if loaded is None else loaded[r["kernel"]],
           "loaders_listen_launches": None if listened is None else listened[r["kernel"]],
           "loaders_speech_launches": None if spoken_files is None else spoken_files[r["kernel"]],
           "loaders_voice_launches": None if voiced_files is None else voiced_files[r["kernel"]],
           "loaders_music_launches": None if music_files is None else music_files[r["kernel"]],
           "parallel_launches": None if paralleled is None else paralleled[r["kernel"]],
           "on_main_path": r["on_main_path"],
           "on_engines_path": r.get("on_engines_path", False),
           "on_chatterbox_path": r.get("on_chatterbox_path", False),
           "on_transcribe_path": r.get("on_transcribe_path", False),
           "on_music_path": r.get("on_music_path", False),
           "on_lora_path": r.get("on_lora_path", False),
           "bound_parts_ms": r["bound_parts_ms"]}
        | {k: r[k] for k in ("k1_route", "k2_route", "k3_route", "k6_route", "k7_route",
                             "core_ms", "backward", "grad") if k in r}
        for r in kernel_recs]}))
    mark("end")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
