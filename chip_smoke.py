#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU: the inference
and training paths of the cylinder ``epd`` and of the graph transformer,
on the cylinder mesh (NK layout) and on the graded mesh (CSR layout), the
Transolver++ train step with its gumbel kernel, the train -> predict
loop (loader, Trainer.fit, checkpoint and resume, predict), and
DeformingPlate (training_config/plate.json) with its world edges through
the attention kernels' world seam, the panels workload
(training_config/panels.json: hidden 128, the physics losses) through the
hidden-128 gated-FFN kernels, ``epd`` at MeshGraphNets' width (hidden
128, 15 blocks) through the wide GraphNetBlock kernels, and
DeformingPlate's MeshGraphNet (an ``epd`` with world edges) through the
GraphNetBlock kernels' world seam, DeformingPlate's rollouts with their
world edges found again at every step, the aneurysm configs with the
rollout's previous-data slice, the concat world layout, and both
families trained on sub-mesh partitions (RCB parts through the host mesh
library, csrc/meshops.cc, built with g++).

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --parent CHECKOUT   # also times another checkout's
                                              # GraphNetBlock, FFN-forward and
                                              # attention kernels

Phases (any failure raises, so the exit code is non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc builds every kernel of the port from csrc/ (NK and CSR
     GraphNetBlock, NK and CSR edge attention and gated FFN, each forward
     and backward, and the gumbel perturbation), one process per source,
     all at once; ptxas's registers and spills of the redesigned kernels
     (the gated-FFN forward and backward, both GraphNetBlock forwards,
     both backwards' passes and their tile pre-pass, and the four edge
     attention kernels: each layout's forward and backward passes) on lines
     of their own;
  3. kernel check: each forward variant (folded encoder, middle block,
     last block) against its plain PyTorch version at the slice's shape
     (1,920 nodes x 128 samples x hidden 32, K=6 slots), same bf16 inputs;
     each variant's time by CUDA events and the profiler's device time;
  4. backward kernel check: each variant's gradients (dx, de or the folded
     encoder's, every weight) from random bf16 cotangents against the
     plain version's autograd in bf16 and in fp32 (utils/gradcheck.py);
     each variant's time (CUDA events and the profiler's device time, and
     the device time by pass) beside its plain backward's;
  5. slice: the B=128 packed eval forward through the kernel path, which
     must launch the kernel once per block, against the plain path;
  6. rollout: 8 windows of one trajectory, 50 steps, kernel path against
     the plain path;
  7. training: 20 train steps of bench.py's configuration (B=128, noise
     σ=0.02, masked L2, AdamW with warmup) on the kernel path, 5 forward
     and 5 backward launches a step, against the same steps on the plain
     path from the same weights and noise;
  8. timing: CUDA-event medians of the forward and the train step on
     both paths, with the kernel path's device times (torch.profiler) and
     the host's time to enqueue a step;
  9. transformer kernel checks, at the transformer slice's shape (1,920
     nodes x 64 samples, hidden 64, 4 heads of 16, K=6): the NK edge
     attention against its plain version on random bf16 q, k, v (and
     exact zeros where a receiver has no valid slot), the softmax
     statistics it keeps under autograd against their plain version
     (``softmax_stats``), the gated FFN against its plain version with
     block 0's weights;
 10. transformer slice: the B=64 packed eval forward of the 10-block
     transformer through the kernel path (each kernel once per block)
     against the plain path, then 8 windows x 50 steps of rollout on both
     paths;
 11. transformer timing: both kernels (by device time too), their plain
     versions and the library's masked attention, one middle block and the
     forward (and its device time) on both paths;
 12. transformer backward kernel checks at the same shape: the attention
     backward and the gated-FFN backward (GELU with block 0's weights, and
     SiLU) against their plain backwards, both against fp32 autograd
     (utils/gradcheck.py); the attention's dk, dv also against plain
     autograd of its forward's plain version; dq exactly 0 where a
     receiver has no valid slot;
 13. transformer training: 20 train steps of scripts/bench_models.py's
     transformer step (B=64, noise σ=0.02, masked L2, AdamW with warmup)
     on the kernel path, 10 forward and 10 backward launches of each
     kernel a step, against the same steps on the plain path;
 14. transformer train timing: each backward kernel (the attention's by
     device time too, and by pass), its plain backward, the library's
     masked attention forward + backward, one middle block forward +
     backward and the train step on both paths, with the step's device
     time, the host's time to enqueue a step and the syncs a step makes;
 15. layout, on the graded mesh (27,000 nodes, ~160k directed edges, a
     long in-degree tail; its statistics are logged first):
     FusedTopologyManager chooses the CSR layout for it for both model
     families (``epd`` and transformer), and still the NK layout for the
     cylinder;
 16. CSR kernel checks at the graded slices' shapes (27,008 nodes x 16
     samples): each CSR GraphNetBlock variant against its plain version
     on the same bf16 inputs; the CSR attention against its plain version
     (ops/edge_attention.edge_attention), with exact zeros on receivers
     without a valid row, and the softmax statistics it keeps under
     autograd (the max, 1/denominator) against their plain version
     (``softmax_stats``); with ``--parent``, the CSR attention's output
     bit for bit against the parent tree's kernel on the same inputs; the
     gated FFN against its plain version on the
     transformer's [27,008, 16, 64] input; each CSR GraphNetBlock
     variant's time by CUDA events and by the profiler's device time;
 17. graded slices: the B=16 eval forward of ``epd`` (5 CSR GraphNetBlock
     launches) and of the transformer (10 CSR attention and 10 FFN
     launches) against the plain path, then 8 windows x 50 steps of
     rollout of each on both paths;
 18. graded timing: both CSR kernels (the attention by device time too),
     their plain versions and bounds, the
     gated FFN (by device time too) and its plain version at the graded
     shape, the library's masked attention where its dense mask fits, one
     middle block and the forward of each model (and its device time) on
     both paths;
 19. CSR backward kernel checks at the graded shapes: each CSR
     GraphNetBlock variant's gradients (dx, de or the folded encoder's,
     every weight) from random bf16 cotangents, the CSR attention's (dq
     exactly 0 where a receiver has no valid row) and the gated FFN's at
     [27,008, 16, 64] with a graded block's weights, each against its plain
     backward and fp32 autograd (utils/gradcheck.py); with ``--parent``,
     the CSR attention's dq, dk, dv bit for bit against the parent tree's
     kernels; each CSR GraphNetBlock backward variant's time as in phase 4,
     by pass too;
 20. graded training: 20 train steps of each family at B=16
     (``entry.graded_train_setup``, ``graded_transformer_train_setup``)
     on the kernel path, 5 + 5 CSR GraphNetBlock launches, or 10 + 10 of
     the CSR attention and of the FFN, a step, against the same steps on
     the plain path; peak device memory of each path;
 21. graded train timing: both CSR backward kernels (the attention's by
     device time too) and their plain backwards, the CSR attention's
     forward + backward beside the library's masked attention forward +
     backward where it fits, one middle block forward + backward of each family and the
     train steps on both paths, with each step's device time and the
     host's time to enqueue it; the gated-FFN backward's time and bound at
     the graded shape;
 22. gumbel kernel check at the Transolver slice's logits [16·2,432, 4, 32]
     (1,920 nodes padded to 2,432 rows, as scripts/bench_models.py's
     graph) and the graded mesh's [16·27,136, 4, 32], bf16: the kernel's Philox
     words equal the plain version's, bit for bit; outputs within 1e-5;
     the gradient is the exact passthrough; over the slice's 5.0M draws
     the noise's mean and std (γ, π/√6), its Kolmogorov-Smirnov statistic
     against the Gumbel CDF, and another key's draw uncorrelated;
 23. Transolver slice (4 blocks, hidden 64, 4 heads, 32 slices, bf16,
     stacked B=16 on the cylinder's 1,920 nodes): the eval forward on both
     paths (no noise, no launch), then 20 train steps of
     ``entry.transolver_train_setup`` on the kernel path, 4 launches a
     step and none in the backward, against the same steps on the plain
     path (the gumbel kernel's plain version on the same keys, so the
     same bits); peak device memory of each path;
 24. Transolver timing: the kernel, its plain version and the torch.rand
     draw (JAX's XLA draw's counterpart) at both shapes with the bound;
     the train steps with the kernel, with the torch.rand draw and on the
     plain path, on the cylinder and on the graded mesh's 27,000 points,
     with the host's time to enqueue a step and the syncs a step makes.
 25. data: a BaseDataset defined here over in-memory trajectories (8 of
     129 frames on the 48x40 cylinder mesh; the card's machine has no
     h5py): every batch the loader delivers to the card, B=128, laid out
     by FusedTopologyManager, equals its numpy source bit for bit, on the
     vectorized lane and frame by frame, over two epochs;
 26. fit: training_config/cylinder.json's model (5 blocks, hidden 32,
     relu, bf16, packed, NK layout, noise σ=0.02) through the port's
     Trainer.fit: 3 epochs of 8 steps at B=128 with a 50-step validation
     rollout each; each epoch's loss and rollout RMSE finite, 5 forward
     and 5 backward launches of the NK GraphNetBlock a step and 5 a
     rollout step; the steady-state step inside fit against
     entry.cylinder_train_setup's step (phase 8); 26b: the transformer
     (2 blocks, hidden 64, 4 heads, B=64), one epoch, 2 + 2 launches of
     the NK attention and of the gated FFN a step;
 27. checkpoint: a run that stops after epoch 2 and resumes from its
     checkpoint (other weights first) ends where an uninterrupted run
     ends (parameters, normalizer accumulators, optimizer state and step):
     on the plain path in PyTorch's default mode bit for bit; on the
     kernel path bit for bit where two uninterrupted runs are (phase 26's
     run against the uninterrupted one, logged), else within
     ``RESUME_REL``;
 28. predict: cli.common.load_inference_stack on phase 26's checkpoint
     with the validation dataset passed in, and cli.predict.predict on
     the fused path: the rollout RMSE equals what validate reported;
 29. world seam: both attention layouts with world pieces
     (ops/edge_attention.world_attention_parts), the NK kernels (rows 5,
     6) at plate's shape (entry.plate_setup: the 44x30 sheet, B=64, each
     frame's sidecar of 1,024 slots), the CSR kernels (rows 7, 8) on the
     graded mesh with a synthetic [1,024, 16] sidecar reaching receivers
     whose rows are masked: the forward against joint_edge_attention, the
     joint statistics against softmax_stats, exact zeros where a receiver
     has neither mesh rows nor world edges, dq, dk, dv, dnum_w, dden_w
     against the plain backward and fp32 autograd, the same bits on two
     calls, without world the parent tree's bits (with --parent); times
     with and without world with their bounds, and the library's masked
     attention over mesh and world edges where its per-sample mask fits;
 30. plate train step: entry.plate_train_setup (plate.json's transformer,
     10 blocks, hidden 64, 4 heads, B=64, budget 1,024, noise 0.003 and
     the world-position features on the device), the layout chosen, 20
     steps with 10 + 10 launches of the attention and FFN kernels a step
     against the plain path; step, enqueue and device time;
 31. plate fit and predict: Trainer.fit of plate.json's model on
     in-memory plate trajectories (2 of 65 frames, B=64, 2 epochs, a
     50-step validation rollout with each frame's sidecar a step), then
     predict from its checkpoint: losses and RMSE finite, launches per
     step and rollout step, predict's RMSE equal to validate's;
 32. panels kernels: rows 9 and 10 at hidden 128 (csrc/fused_ffn128.cu,
     fused_ffn128_bwd.cu) with block 0's weights of the panels model, at
     panels' shape [1,920·64, 128] and at 1,001 x 3 rows: the forward
     against its plain version, the backward against its plain backward
     and fp32 autograd (utils/gradcheck.py), each the same bits on two
     calls; at both shapes their times and device times by kernel
     (ffn128_times; with ``--parent`` the parent tree's in turns), the
     backward's peak allocation and its counted device-memory bytes
     (ffn128_backward_bytes); plain times, bounds and ptxas's registers
     and spills; rows 5 and 6 at panels' head width 32 against their
     plain versions; with ``--parent``, the hidden-64 FFN forward and
     backward bit for bit against the parent tree's;
 33. panels train step: entry.panels_train_setup (panels.json's
     transformer, 15 blocks, hidden 128, 4 heads of 32, B=64, noise 0.01,
     the 4-term MultiLoss on least-squares gradients), 20 steps with 15 +
     15 launches of the attention and of the FFN kernels a step against
     the plain path, each loss term held to the loss's bounds; step,
     enqueue and device time;
 34. panels fit and predict: Trainer.fit of panels.json's model on
     in-memory panels trajectories (3 of 66 frames built as
     ``--external panels`` builds them, B=64, one epoch, a 50-step
     validation rollout), then predict from its checkpoint: losses and
     RMSE finite, the launches of the fit and of predict measured and
     checked, predict's RMSE equal to validate's.
 35. wide GraphNetBlock kernels: rows 1-4 at hidden 64 and 128
     (csrc/fused_gnblock_wide_nk.cu, _nk_bwd.cu, _csr.cu, _csr_bwd.cu, one
     library a width), each variant (folded, middle, last) in both layouts
     at the cylinder NK shape (1,920 nodes x 128 samples) and the graded
     CSR shape (27,008 x 16), then at an odd batch (33) on the cylinder
     and on a hub graph (a receiver of in-degree 150, receivers with no
     row or only masked rows, B=17): the forward against its plain version
     (0.05), the backward against its plain backward and fp32 autograd
     (utils/gradcheck.py), the backward's gradients the same bits on two
     calls; each variant's times at the two shapes, the bounds and
     ptxas's registers and spills; with ``--parent``, the hidden-32
     instances bit for bit against the parent tree's (the folded forward's
     outputs, the middle backward's dx and de: the parent's weight
     gradients are atomic sums, other bits on every call);
 36. MeshGraphNets' width: 20 train steps of ``epd`` at hidden 128 and 15
     blocks (entry.cylinder_train_setup, B=128, NK) with 15 + 15 launches
     of rows 1/2 a step, their peak memory, the step's wall, enqueue and
     device time; the first 7 steps at B=32 against the plain path (its
     fp32 step-1 gradients do not fit in 80 GB at B=128; the plain path
     repeats itself over those 7 steps only: this training is chaotic,
     MGN_COMPARED_STEPS), the peak memory of each; 5 steps of the graded
     mesh's ``epd`` at hidden 128 (B=16, CSR, rows 3/4) and of both at
     hidden 64 against the plain path;
 37. Trainer.fit of training_config/cylinder.json with hidden_size 128
     and message_passing_num 15 set in memory (2 trajectories of 129
     frames, B=128, one epoch, a 50-step validation rollout), then predict
     from its checkpoint: launches held to the prediction, predict's RMSE
     equal to validate's.
 38. the world seam of rows 1-4 (``extra_agg``, the world edges'
     aggregate) at hidden 32, 64 and 128, at the cylinder NK shape (1,920
     nodes x 128 samples) and the graded CSR shape (27,008 x 16), with a
     dense random extra aggregate: each forward variant against its plain
     version (0.05), the middle block's backward (dx, de, dea and every
     weight gradient) against its plain backward and fp32 autograd
     (utils/gradcheck.py), a zero extra giving the bits of none, forward
     and backward; each middle block's times with and without the extra,
     its plain version's and its bound;
 39. DeformingPlate's MeshGraphNet (entry.plate_epd_train_setup: hidden
     128, 15 blocks, the 44x30 sheet in the NK layout, B=64 frames that
     all have world edges, checked): 15 + 15 launches of rows 1/2 a step,
     the first PLATE_EPD_COMPARED_STEPS steps against the plain path (over
     which the plain path repeats itself), the peak memory, the step's
     wall, enqueue and device time;
 40. plate.json with that model (set in memory) through Trainer.fit (2
     trajectories of 65 frames, B=64, one epoch, a 50-step validation
     rollout), then predict from its checkpoint: launches held to the
     prediction, predict's RMSE equal to validate's.
 41. dynamic world edges: DeformingPlate rolled out from frame 0 of 8
     synthetic 44x30 plates whose obstacles descend at different rates, 16
     steps, packed R=8 with 1,024 sidecar slots the rollout fills at every
     step (entry.plate_rollout_setup, training/rollout.DynamicWorldEdges),
     plate.json's transformer (rows 5 and 9) and DeformingPlate's
     MeshGraphNet (row 1 with the world aggregate), in both tracks: every
     search's pairs against ops/knn.radius_edges on the CPU for the same
     positions (pairs on the radius counted), the ground-truth track's
     pairs against the host sidecar's plus the in-radius mesh edges, the
     launches against the prediction, the kernel path's RMSE within
     ROLLOUT_RTOL of the plain path's; a rollout step's time with and
     without the search, and the search's;
 42. previous data: coarse-aneurysm.json and pinn-aneurysm.json (10
     blocks, hidden 64, 4 heads, ``--external aneurysm``) through
     Trainer.fit on in-memory synthetic aneurysm trajectories (1,408
     nodes), the rollouts carrying the acceleration columns, then predict
     as ``--use_previous_data --bf16 --fused`` runs it: launches, finite
     losses, predict's RMSE validate's, the kernel path's rollout within
     ROLLOUT_RTOL of the plain path's, the carry changing the plain
     rollout;
 43. the concat world layout: plate.json unpacked (world edges after each
     frame's mesh edges), 2 train steps of Trainer.fit on the plain path,
     finite losses, no kernel launch;
 44. sub-mesh partitions, epd: cylinder.json's model (hidden 32, 5
     blocks) through Trainer.fit on the RCB parts of a 128x64 cylinder
     grid (8,192 nodes), 4 parts and parts of at most 3,000 nodes (3, of
     odd sizes), validation on the full mesh: the host mesh library's
     parts equal its plain version's, one layout a part plus the full
     mesh, rows 1/2 (3/4 where a part takes CSR) launched blocks x steps
     (+ validation) times, finite losses within LATER_LOSS_RTOL of the
     same fit on the plain path, predict's RMSE validate's, the rollout's
     first frame through utils/vtu.py and back; every function of the
     host mesh library against its plain version on this mesh; the
     loader's host ms a batch with partitions and without, on the library
     and on its plain versions; a step's time on a part;
 45. sub-mesh partitions, transformer: coarse-aneurysm.json (10 blocks,
     hidden 64, 4 heads, ``--external aneurysm``, previous data) on the
     parts (at most 512 nodes: 3) of phase 42's 1,408-node mesh, the same
     checks with rows 5/6 (7/8) and 9/10.
 46. rows 5-10 at every width JAX fuses that had no instance before: the
     gated FFN at hidden 32, 16, 8, 4, 2 and 1 (csrc/fused_ffn_small.cu,
     fused_ffn_small_bwd.cu, a library a width) at the cylinder
     transformer's [1,920·64, h] rows, and both layouts' attention at
     head widths 8, 4, 2, 1, 64 and 128 (4, 4, 4, 4, 2 and 1 heads) at
     the cylinder's NK shape and the graded mesh's CSR shape: each
     forward against its plain version, each backward against its plain
     backward and fp32 autograd (utils/gradcheck.py), the same bits on
     two calls, exact zeros where a receiver has no valid row, the kept
     statistics; the world seam at head widths 8 and 64 in both layouts
     (phase 29's checks); ptxas's registers and spills, each instance's
     time and device time (one profiler sweep a direction), its plain
     version's, its bound and the library's masked attention;
 47. each of those widths on its path, counts set to 0 just before: a
     2-block transformer (hidden, heads: 32, 4; 16, 4; 8, 4; 4, 4; 2, 2;
     1, 1; 128, 2; 128, 1) on the cylinder (NK, B=16) and on a 4,000-node
     graded mesh (CSR, B=4): the eval forward and one train step against
     the plain path, each block launching its attention and FFN kernels
     once forward and once backward;
 48. the hidden-32 transformer with 4 heads (head width 8;
     entry.transformer_train_setup: 10 blocks, B=64, the cylinder mesh,
     NK): 20 train steps against the plain path, the step's wall, device
     and enqueue time; then Trainer.fit (2 trajectories of 129 frames,
     B=64, one epoch, a 50-step validation rollout) and predict from its
     checkpoint: launches held to the prediction, predict's RMSE
     validate's. Besides, the attention kernels at head widths 16 and 32,
     the FFN (GELU) at every hidden width and rows 1-4 (relu) at hidden
     32, 64 and 128 give the bits the earlier trees gave on
     scripts/kernel_digests.py's inputs (its RECORDED digests).
 49. rows 1-4 at every width and activation JAX fuses that had no
     instance before: relu at hidden 16, 8, 4, 2 and 1 (csrc/
     fused_gnblock_{nk,csr}{,_bwd}.cu built once a width), silu and exact
     gelu at every hidden width 1 to 128, at the cylinder's NK shape
     (B=32) and a graded mesh's CSR shape (8,000 nodes, B=8): each
     forward against its plain version, each backward against its plain
     backward and fp32 autograd (utils/gradcheck.py), relu in NK every
     variant (the encoder folded at 16 and 8, the first block on encoded
     edges below), the middle block otherwise, its backward the same bits
     on two calls; the world seam at hidden 16 and 4 in both layouts;
     ptxas's registers and spills, each instance's times (CUDA events,
     the profiler's device time), its plain version's and its bound;
 50. each of those instances on its path, counts set to 0 just before: a
     2-block ``epd`` whose blocks take the width and activation, on the
     cylinder (20 x 16, NK, B=8) and a 4,000-node graded mesh (CSR, B=4):
     the eval forward and one train step against the plain path, each
     block launching rows 1/2 (3/4) once forward and once backward;
 51. ``epd`` at hidden 16 (entry.cylinder_train_setup(hidden=16): 5
     blocks, B=128, NK, the encoder folded): the middle block's kernels
     timed at B=128, 20 train steps against the plain path, the step's
     wall, device and enqueue time; Trainer.fit (2 trajectories of 129
     frames, B=128, one epoch, a 50-step validation rollout) and predict
     from its checkpoint: launches held to the prediction, predict's
     RMSE validate's.
 52. rows 1-4 with MLPs of 1, 2, 3, 5 and 8 Dense layers, each with and
     without the RMSNorm tail, at hidden 32, 8, 64 and 128 in both
     layouts, at phase 49's shapes: each forward against its plain
     version, each backward against its plain backward and fp32 autograd,
     the first block folded (NK) and a middle block, the middle block's
     backward the same bits on two calls, the world seam at 3 layers
     without the norm and 8 with it; each case's times by CUDA events
     (the profiler's device time at those two), bound, ptxas's registers
     and spills; then each case on its path as in phase 50;
 53. ``epd`` at MeshGraphNets' width (hidden 128, 15 blocks, NK, the
     encoder folded) with 3-layer MLPs: 20 train steps at B=128 (15 + 15
     launches a step), the step's wall, device and enqueue time, 7 steps
     at B=32 against the plain path, a B=128 forward and an 8 x 50
     rollout against the plain path's; the cylinder ``epd`` at hidden 32
     with 2-layer MLPs without the norm: 20 train steps at B=128 against
     the plain path, timed.
Before the device JSON, the last line, come the card's name and the
kernels' JSON record (launches on the main paths, errors, times, bounds;
the gumbel kernel's ``library_ms`` is the torch.rand draw's time; both
GraphNetBlock kernels, forward and backward, at hidden 32 and (records of
their own, ``_h64`` and ``_h128``) at hidden 64 and 128, add each
variant's times under ``variants``, the wide ones ptxas's report under
``ptxas``, both hidden-128 FFN kernels ptxas's report under
``ptxas``, every GraphNetBlock, gated-FFN and attention kernel
its profiler device time under ``device_ms``, both gated-FFN kernels
their graded-shape times and bound under ``graded``, both attention
backwards their forward + backward under ``fwd_bwd_ms`` and
``fwd_bwd_device_ms`` and their device time by pass under ``passes``;
rows 1-4 at each width their world seam's check and times under
``world``, rows 1/2 at hidden 128 their bound at the plate MeshGraphNet's
shape under ``plate``, rows 5/6 their times, library time and bound at
panels' head width 32 under ``head_width_32``; rows 5-10 at the new
widths records of their own, ``fused_gated_ffn_h{32,16,8,4,2,1}`` and
``fused_edge_attention_{nk,csr}_dh{8,4,2,1,64,128}``, each with its
backward, their ptxas reports under ``ptxas``; rows 1-4 at the new widths
and activations records of their own,
``fused_gn_block_{nk,csr}_h{16,8,4,2,1}`` and
``fused_gn_block_{nk,csr}_h{1,...,128}_{silu,gelu}``, each with its
backward, their ptxas reports under ``ptxas``, the hidden-16 NK pair its
times at the main path's B=128 under ``slice``; rows 1-4 with MLPs of
other depths or without the norm records of their own,
``fused_gn_block_{nk,csr}_h{32,8,64,128}_depths`` and their backwards,
each case's check, times, bound and launches under ``depths`` (keys
``3``, ``3_bare`` ...), the record's times those of 3 layers without the
norm).
With ``--parent CHECKOUT`` the libraries that PARENT_LIBS names (both
GraphNetBlock forwards and backwards, the hidden-64 and hidden-128
gated-FFN forwards and backwards, both layouts' attention forward and
backward) are built from that checkout's
csrc/ too, and the same calls (each GraphNetBlock kernel variant, the
backwards by pass too; the FFN forward at both shapes; the hidden-128
FFN forward and backward at both of phase 32's shapes; each attention's
forward, backward (by pass too for the NK one) and both together; the
cylinder and graded forwards and train steps of both families) are timed
with them in turns with this tree's, on the same inputs and card, under
``parent_ms`` and ``parent_device_ms``: the before numbers of a redesign.
A library whose C interface changed is called through the checkout's own
op module (``PARENT_OWN_OPS``).
It imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
import functools
import inspect
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda:0"
#: kernel vs plain version, rtol = atol (tests/test_fused_gnblock_nk.py:101-106)
KERNEL_TOL = 0.05
#: kernel path vs plain path of the whole model, rtol = atol, valid nodes
#: (tests/test_fused_gnblock_nk.py:305-308)
SLICE_TOL = 0.15
#: per-trajectory rollout RMSE, kernel path vs plain path, relative
ROLLOUT_RTOL = 0.15
ROLLOUT_WINDOWS = 8
ROLLOUT_STEPS = 50
TRAIN_STEPS = 20
#: step-1 loss, kernel path vs plain path, relative (the JAX suite's value
#: bound, tests/test_fused_gnblock_nk.py:150)
STEP1_LOSS_RTOL = 0.02
#: step-1 gradients, |a - b| <= 0.04 · max|b| over all parameters together
#: (tests/test_fused_gnblock_nk.py:150-156); PERF.md §6 says why not per
#: parameter
STEP1_GRAD_REL = 0.04
#: loss on steps 2..20, kernel path vs plain path, relative: 10x the
#: largest difference of the first run on the card, 9.5e-5 (PERF.md §6)
LATER_LOSS_RTOL = 1e-3
#: phase 27: the resumed run against an uninterrupted one, each part of the
#: state as one vector (``state_diff``). The plain path (its sums in a fixed
#: order, ops/segment.py) resumes bit for bit. Where two uninterrupted runs on the kernel
#: path agree bit for bit (the GraphNetBlock backwards sum their weight
#: gradients in block order, csrc/gn_bwd_common.cuh), so must the resumed
#: one; where they do not, it is held within RESUME_REL: 24 Adam steps
#: amplify a last-bit difference to ~1e-2 in Adam's first moments
RESUME_REL = 1e-2
#: phase 28: predict's rollout RMSE is computed in fp32 on the card,
#: validate's in float64 from the same squared-error sums
PREDICT_RTOL = 1e-6
#: attention kernel vs plain version (tests/test_fused_edge_attention_nk.py:96-99)
ATTN_RTOL, ATTN_ATOL = 0.03, 0.02
#: gated-FFN kernel vs plain version, rtol = atol (tests/test_fused_ffn.py:27-30)
FFN_TOL = 0.05
#: transformer kernel path vs plain path, rtol = atol, valid nodes
#: (tests/test_fused_edge_attention_nk.py:171)
TF_SLICE_TOL = 0.1
#: an attention's kept statistics against their plain version
#: (ops/fused_edge_attention_csr.softmax_stats): the max logit, rtol =
#: atol, the logits' fp32 sum order; 1/denominator, relative, a logit an
#: ulp apart rounding its bf16 weight the other way (2^-8 of one term)
STATS_MAX_TOL, STATS_INV_RTOL = 1e-5, 5e-3
#: receivers per node block whose slots the empty-receiver check masks out
EMPTY_RECEIVERS = 5
#: the card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
#: and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
#: the kernels whose ptxas reports (registers, spills) are logged apart:
#: the gated-FFN forward and backward (every hidden width), both
#: GraphNetBlock forwards and both backwards' passes, the tile pre-pass
#: they share, and both layouts' attention forward and backward passes
#: (every head width)
REDESIGNED = ("ffn_fwd_kernel", "ffn_bwd_kernel", "ffn128_", "ffn_small_", "gn_nk_fwd_kernel",
              "gn_nk_bwd_", "gn_csr_fwd_kernel", "gn_csr_bwd_", "gn_partial_tc_kernel",
              "ea_csr_fwd_kernel", "ea_csr_bwd_", "ea_nk_fwd_kernel", "ea_nk_bwd_")
FWD = {"name": "fused_gn_block_nk", "source": "graph_physics_tpu_torch/csrc/fused_gnblock_nk.cu",
       "replaces": "graph_physics_tpu/ops/fused_gnblock_nk.py:147"}
BWD = {"name": "fused_gn_block_nk_backward",
       "source": "graph_physics_tpu_torch/csrc/fused_gnblock_nk_bwd.cu",
       "replaces": "graph_physics_tpu/ops/fused_gnblock_nk.py:189"}
ATTN = {"name": "fused_edge_attention_nk",
        "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_nk.cu",
        "replaces": "graph_physics_tpu/ops/fused_edge_attention_nk.py:476"}
FFN = {"name": "fused_gated_ffn", "source": "graph_physics_tpu_torch/csrc/fused_ffn.cu",
       "replaces": "graph_physics_tpu/ops/fused_ffn.py:74"}
ATTN_BWD = {"name": "fused_edge_attention_nk_backward",
            "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_nk_bwd.cu",
            "replaces": "graph_physics_tpu/ops/fused_edge_attention_nk.py:495"}
FFN_BWD = {"name": "fused_gated_ffn_backward",
           "source": "graph_physics_tpu_torch/csrc/fused_ffn_bwd.cu",
           "replaces": "graph_physics_tpu/ops/fused_ffn.py:99"}
GN_CSR = {"name": "fused_gn_block_csr", "source": "graph_physics_tpu_torch/csrc/fused_gnblock_csr.cu",
          "replaces": "graph_physics_tpu/ops/fused_gnblock.py:392"}
ATTN_CSR = {"name": "fused_edge_attention_csr",
            "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_csr.cu",
            "replaces": "graph_physics_tpu/ops/fused_edge_attention.py:124"}
GN_CSR_BWD = {"name": "fused_gn_block_csr_backward",
              "source": "graph_physics_tpu_torch/csrc/fused_gnblock_csr_bwd.cu",
              "replaces": "graph_physics_tpu/ops/fused_gnblock.py:453"}
ATTN_CSR_BWD = {"name": "fused_edge_attention_csr_backward",
                "source": "graph_physics_tpu_torch/csrc/fused_edge_attention_csr_bwd.cu",
                "replaces": "graph_physics_tpu/ops/fused_edge_attention.py:143"}
#: receivers of the graded mesh whose rows the empty-receiver check masks
#: out: every EMPTY_STRIDE-th
EMPTY_STRIDE = 97
GUMBEL = {"name": "gumbel_perturb", "source": "graph_physics_tpu_torch/csrc/gumbel.cu",
          "replaces": "graph_physics_tpu/ops/gumbel.py:51"}
#: gumbel kernel vs plain version on the same bits, max abs: logf on the
#: card against torch.log, at |noise| < 17 (a few fp32 ulps)
GUMBEL_ATOL = 1e-5
#: mean and std of the draws against γ and π/√6, in standard errors of
#: Gumbel(0, 1)'s sample mean and std (σ/√n = 1.2825/√n and, with its
#: excess kurtosis 2.4, σ·√(4.4/4)/√n = 1.345/√n; the larger is taken):
#: 0.0042 over the 5.0M draws of the slice's shape
GUMBEL_MOMENT_SES, GUMBEL_SE_COEFF = 7.0, 1.345
#: Kolmogorov-Smirnov statistic against the Gumbel CDF: the α = 0.001
#: critical value is KS_COEFF / sqrt(draws)
KS_COEFF = 1.949


def log(*args):
    print(*args, flush=True)


def kernel_resources(build_log, keys):
    """{kernel: its ptxas report (registers, spill stores and loads)} for
    the entry functions whose mangled names hold one of ``keys``, from
    nvcc's -Xptxas=-v output."""
    found, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            current = name if any(k in name for k in keys) else None
            if current:
                found[current] = []
        elif current and ("registers" in line or "spill" in line):
            found[current].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in found.items()}


def compare(name, got, want, rtol, rows=None, atol=None):
    """Max abs / rel error; raises unless |got - want| <= atol + rtol·|want|
    (atol = rtol unless given)."""
    import torch

    atol = rtol if atol is None else atol
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    big = want.abs() >= atol  # where a relative error means something
    max_rel = (diff[big] / want.abs()[big]).max().item() if big.any() else 0.0
    bad = int((diff > atol + rtol * want.abs()).sum())
    log(f"  {name}: max_abs_err {max_abs:.6g} max_rel_err {max_rel:.6g} where |ref| >= {atol} "
        f"(rtol={rtol}, atol={atol}, {bad} of {diff.numel()} outside)")
    if bad:
        raise AssertionError(f"{name}: {bad} values outside rtol={rtol}, atol={atol}")
    return max_abs


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the bf16
    tensor-core peak (the kernels' inputs are bf16)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / BF16_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gn_block_work(x, e, edge_mask, blk, backward=False):
    """(bytes, FLOPs) of one middle GraphNetBlock on these inputs (either
    layout): x and e read, x_out and e_out written (bf16), the fp32 weights
    read, the row arrays read; the edge MLP on valid rows only, its first
    layer's receiver and sender parts (x @ Kr, x @ Ks) once per node, as
    the function allows and the kernels form them, the node MLP on every
    node. The backward also reads both cotangents, writes dx and de (bf16)
    and fp32 weight gradients, and does three times the forward's
    multiply-adds (recompute, input and weight gradients)."""
    n, b, h = x.shape
    rows = e.shape[0]
    acts = 2 * (x.numel() + e.numel())  # bf16 bytes of x and e
    params = sum(p.numel() for p in blk.parameters())
    edge_w = sum(d.weight.numel() for d in blk.edge_block.denses)
    macs = (int(edge_mask.sum()) * b * (edge_w - 2 * h * h)
            + n * b * (2 * h * h + sum(d.weight.numel() for d in blk.node_block.denses)))
    if backward:
        return 3 * acts + 8 * params + 5 * rows, 3 * 2 * macs
    return 2 * acts + 4 * params + 5 * rows, 2 * macs


def ffn_backward_times(kept):
    """The gated-FFN backward's times from the retained graphs of
    ``gradcheck.check_backward``: one autograd call through the kernel by
    CUDA events, its device time by the profiler (a call of a fraction of
    a millisecond is otherwise timed with the host's launch), and the
    plain backward's by CUDA events."""
    import torch

    def grad(k):
        return lambda: torch.autograd.grad(*kept[k], retain_graph=True)

    return {"ms": cuda_ms(grad("kernel")), "device_ms": device_ms(grad("kernel")),
            "plain_ms": cuda_ms(grad("plain"))}


def ffn128_backward_bytes(rows, params):
    """The bytes the hidden-128 FFN backward moves to and from device memory
    in a call over ``rows`` rows, as its source's header counts them: x and
    g read once, dx written (bf16); its clusters' partials written and read
    back, the packed weights written and read, the fp32 parameters read and
    the gradients written."""
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import kernel_build

    lib = kernel_build.load("ffn128_bwd", ffn_ops._ARGTYPES["ffn128_bwd"])
    clusters = lib.ffn128_bwd_clusters(rows)
    return (3 * 2 * rows * 128 + 2 * 4 * clusters * lib.ffn128_bwd_sizes(1)
            + 2 * lib.ffn128_bwd_sizes(0) + 4 * params + 4 * lib.ffn128_bwd_sizes(2))


def ffn128_times(x, cot, mlp, norm2):
    """The hidden-128 gated FFN's times at ``x``: the forward and one
    backward (``autograd.grad`` on a graph retained for the turn) by CUDA
    events, their device time by kernel (the profiler), and the bytes a
    backward call allocates at its peak beyond what was allocated before
    it; with a parent tree the same under ``parent_``, taken in turns
    (parent, this tree, this tree, parent) through the parent's wrapper and
    libraries, each number the mean of its pair."""
    import torch
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops

    ffn = late(ffn_ops.fused_gated_ffn)
    params = ffn_ops._params(mlp, norm2)

    def turn():
        def forward():
            with torch.inference_mode():
                ffn(x, mlp, norm2)

        xl = x.clone().requires_grad_(True)
        y = ffn(xl, mlp, norm2)

        def backward():
            torch.autograd.grad(y, [xl, *params], cot, retain_graph=True)

        backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        backward()
        torch.cuda.synchronize()
        return {"fwd_ms": cuda_ms(forward), "fwd_kernels": device_times(forward),
                "bwd_ms": cuda_ms(backward), "bwd_kernels": device_times(backward),
                "bwd_peak_bytes": torch.cuda.max_memory_allocated() - base}

    if PARENT is None:
        turns = {"": [turn()]}
    else:
        with parent_kernels("ffn128", "ffn128_bwd"):
            p1 = turn()
        c1, c2 = turn(), turn()
        with parent_kernels("ffn128", "ffn128_bwd"):
            p2 = turn()
        turns = {"": [c1, c2], "parent_": [p1, p2]}
    out = {}
    for prefix, runs in turns.items():
        for key in ("fwd_ms", "bwd_ms", "bwd_peak_bytes"):
            out[prefix + key] = sum(r[key] for r in runs) / len(runs)
        for key in ("fwd_kernels", "bwd_kernels"):
            names = sorted({k for r in runs for k in r[key]})
            out[prefix + key] = {k: sum(r[key].get(k, 0.0) for r in runs) / len(runs)
                                 for k in names}
            out[prefix + key[:3] + "_device_ms"] = sum(out[prefix + key].values())
    return out


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
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


#: profiler sessions tried for two that agree on every kernel's launches
#: a call: the profiler on the card drops a few launches of a session now
#: and then, and now and then every launch of a session (PERF.md §6)
PROFILE_ATTEMPTS = 6


def _profile_session(fn, reps):
    """({kernel: device ms in all}, {kernel: launches}) of ``reps`` calls
    of ``fn`` by torch.profiler, after one traced warm-up call that is not
    kept (user annotations left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    totals, counts = defaultdict(float), defaultdict(int)
    for ev in prof.key_averages():
        # a user annotation's range (the optimizer step's) spans the host's
        # gaps between its kernels: no kernel's time
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            totals[ev.key] += (getattr(ev, "self_device_time_total", None) or getattr(
                ev, "self_cuda_time_total", 0.0)) / 1e3
            counts[ev.key] += ev.count
    return dict(totals), dict(counts)


def device_times(fn, reps=20):
    """Device milliseconds per call of ``fn`` by CUDA kernel name, from
    torch.profiler over ``reps`` calls (user annotations left out). Each
    kernel's time is its mean launch times its launches a call: the
    launches a session recorded, rounded up to a whole number a call,
    which is exact while the session lost fewer than ``reps`` of that
    kernel's launches. The first two sessions that agree on every
    kernel's launches a call give the mean of their times. When
    ``PROFILE_ATTEMPTS`` sessions give no such two, each kernel takes the
    most launches a call that a session recorded (the profiler loses
    launches and has never added one) and its mean launch over the
    sessions that recorded it. When no session recorded a launch, the
    calls' total comes from ``queued_device_ms`` under one name."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_ATTEMPTS):
        totals, counts = _profile_session(fn, reps)
        if not counts:
            log(f"  the profiler recorded no launch in {reps} calls; profiling again")
            continue
        per_call = {k: -(-c // reps) for k, c in counts.items()}
        dropped = sum(per_call[k] * reps - c for k, c in counts.items())
        if dropped:
            log(f"  the profiler dropped {dropped} of {sum(per_call.values()) * reps} "
                f"launches in {reps} calls (each kernel's time is its mean launch times its "
                f"launches a call)")
        times = {k: totals[k] / counts[k] * per_call[k] for k in counts}
        for other, other_per_call, _, _ in seen:
            if other_per_call == per_call:
                return {k: (times[k] + other[k]) / 2 for k in times}
        if seen:
            log("  two profiler sessions disagree on a kernel's launches a call; profiling "
                "again")
        seen.append((times, per_call, totals, counts))
    if not seen:
        ms = queued_device_ms(fn, reps)
        log(f"  {PROFILE_ATTEMPTS} profiler sessions recorded no launch; by CUDA events "
            f"around {reps} calls queued behind a sleeping kernel: {ms:.4f} ms a call")
        return {QUEUED_KERNELS: ms}
    kernels = {k for _, per_call, _, _ in seen for k in per_call}
    most = {k: max(s[1].get(k, 0) for s in seen) for k in kernels}
    log(f"  {PROFILE_ATTEMPTS} profiler sessions gave no two that agree on every kernel's "
        f"launches a call; each kernel takes the most a session recorded: "
        + ", ".join(f"{k[:40]} {most[k]} (sessions {[s[1].get(k, 0) for s in seen]})"
                    for k in sorted(kernels)
                    if len({s[1].get(k, 0) for s in seen}) > 1))
    return {k: most[k] * sum(s[2].get(k, 0.0) for s in seen)
            / sum(s[3].get(k, 0) for s in seen) for k in kernels}


#: the one name ``device_times`` gives the calls' total when the profiler
#: recorded no launch
QUEUED_KERNELS = "all kernels (CUDA events, queued behind a sleep)"


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms():
    """Cycles of ``torch.cuda._sleep`` that take a millisecond on the card."""
    import torch

    cycles = 10_000_000
    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def queued_device_ms(fn, reps):
    """Device milliseconds per call of ``fn`` without the profiler: CUDA
    events around ``reps`` calls that the host queues while a sleeping
    kernel holds the stream, so that the device runs them back to back.
    The sleep outlasts ``reps`` whole calls timed on the host; a call that
    waits for the device on the host still counts its gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (1.5 * host_ms * reps + 2.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``: the summed time of the CUDA
    kernels ``reps`` calls launch, by torch.profiler. Unlike ``cuda_ms``
    it leaves out the gaps where the device waits for the host, which
    dominate a call of a few microseconds of kernels."""
    return sum(device_times(fn, reps).values())


#: the backward kernels (GraphNetBlock, CSR attention) by a substring of
#: their names
BWD_PASSES = (("pre-pass", "gn_partial"), ("node-MLP pass", "nodemlp"),
              ("row pass", "_row_kernel"), ("sender pass", "send_kernel"),
              ("receiver pass", "recv_kernel"), ("pre-pass", "_partial"),
              ("node-MLP pass", "_node_bwd"), ("row pass", "_row_bwd"),
              ("sender pass", "_send"), ("encoder passes", "_enc_"),
              ("weight-gradient pass", "_wgrad"), ("ordered sum", "_wsum"),
              ("packing", "_pack"))


def pass_split(fn):
    """{pass: device ms per call} of a GraphNetBlock or CSR attention
    backward call, the rest (buffer fills, the gradients' rounding) under
    "other"."""
    split = defaultdict(float)
    for name, ms in device_times(fn).items():
        split[next((p for p, key in BWD_PASSES if key in name), "other")] += ms
    return dict(split)


#: a checkout of the parent tree (``--parent DIR``): its GraphNetBlock
#: libraries are built too and timed on the same inputs in the same run,
#: the before numbers of a redesign on the same card
PARENT = None
#: the libraries a parent tree is timed with, and the op module binding each
PARENT_LIBS = {"gn_csr_fwd": "fused_gnblock_csr", "gn_csr_bwd": "fused_gnblock_csr",
               "gn_nk_fwd": "fused_gnblock_nk", "gn_nk_bwd": "fused_gnblock_nk",
               "ffn": "fused_ffn", "ffn_bwd": "fused_ffn",
               "ffn128": "fused_ffn", "ffn128_bwd": "fused_ffn",
               "edge_attention_csr": "fused_edge_attention_csr",
               "edge_attention_csr_bwd": "fused_edge_attention_csr",
               "edge_attention_nk": "fused_edge_attention_nk",
               "edge_attention_nk_bwd": "fused_edge_attention_nk",
               **{f"gn_{lay}_{way}{h}": f"fused_gnblock_{lay}" for lay in ("nk", "csr")
                  for way in ("fwd", "bwd") for h in (64, 128)}}
#: op modules whose C interface this tree changed: the parent's is loaded
#: from its checkout and binds its libraries, and inside ``parent_kernels``
#: its wrapper (the function of the module's name) stands in for this
#: tree's, in the op module and in models.layers (which calls it by name)
PARENT_OWN_OPS = {"fused_edge_attention_csr", "fused_edge_attention_nk", "fused_ffn",
                  "fused_gnblock_csr", "fused_gnblock_nk"}
#: the wrapper an op module is named for, where its name is not the
#: module's (``fused_gnblock_*`` modules: ``fused_gn_block_*``)
WRAPPERS = {"fused_ffn": "fused_gated_ffn"}
#: each layout's attention libraries, forward and backward
ATTN_CSR_LIBS = ("edge_attention_csr", "edge_attention_csr_bwd")
ATTN_NK_LIBS = ("edge_attention_nk", "edge_attention_nk_bwd")
_parent_builds, _parent_libs, _parent_ops = {}, {}, {}


def start_parent_builds():
    """One nvcc process per parent library, all started at once."""
    from graph_physics_tpu_torch.ops import kernel_build

    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    for name in PARENT_LIBS:
        src = PARENT / "graph_physics_tpu_torch" / "csrc" / kernel_build.LIBRARIES[name][0]
        out = out_dir / f"lib{name}.so"
        proc = subprocess.Popen([nvcc, *kernel_build.NVCC_FLAGS, *kernel_build.FLAGS.get(name, ()),
                                 "-o", str(out), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _parent_builds[name] = (proc, out)


def parent_ops(module):
    """The op module ``module`` (under ops/) of this tree, or, for one in
    ``PARENT_OWN_OPS``, the parent checkout's, loaded from its file (its
    imports resolve to this tree's package)."""
    import importlib
    import importlib.util

    if module not in PARENT_OWN_OPS:
        return importlib.import_module(f"graph_physics_tpu_torch.ops.{module}")
    if module not in _parent_ops:
        path = PARENT / "graph_physics_tpu_torch" / "ops" / f"{module}.py"
        spec = importlib.util.spec_from_file_location(f"parent_tree_{module}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _parent_ops[module] = mod
    return _parent_ops[module]


def parent_library(name):
    """The parent's library ``name``, loaded with its op module's argtypes."""
    import ctypes

    if name not in _parent_libs:
        proc, out = _parent_builds[name]
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{text}")
        lib = ctypes.CDLL(str(out))
        ops = parent_ops(PARENT_LIBS[name])
        for fn, types in ops._ARGTYPES[name].items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _parent_libs[name] = lib
    return _parent_libs[name]


@contextlib.contextmanager
def parent_kernels(*names):
    """Inside the block the ops launch the parent's libraries ``names``,
    through the parent's wrappers where its C interface differs
    (``PARENT_OWN_OPS``)."""
    import importlib

    from graph_physics_tpu_torch.models import layers
    from graph_physics_tpu_torch.ops import kernel_build

    saved = {n: kernel_build._libs.get(n) for n in names}
    kernel_build._libs.update({n: parent_library(n) for n in names})
    swapped = []
    for module in sorted({PARENT_LIBS[n] for n in names} & PARENT_OWN_OPS):
        ours = importlib.import_module(f"graph_physics_tpu_torch.ops.{module}")
        wrapper = WRAPPERS.get(module, module.replace("gnblock", "gn_block"))
        theirs = getattr(parent_ops(module), wrapper)
        if "attention" in module:
            theirs = with_receivers(theirs)
        elif "gnblock" in module:
            theirs = without_extra_agg(theirs)
        for holder in (ours, layers):
            swapped.append((holder, wrapper, getattr(holder, wrapper)))
            setattr(holder, wrapper, theirs)
    try:
        yield
    finally:
        for holder, attr, fn in reversed(swapped):
            setattr(holder, attr, fn)
        for n, lib in saved.items():
            if lib is None:
                kernel_build._libs.pop(n, None)
            else:
                kernel_build._libs[n] = lib


@functools.lru_cache(maxsize=None)
def without_extra_agg(fn):
    """A GraphNetBlock wrapper called as this tree's are: a parent tree's
    that takes no ``extra_agg`` (the world seam) gets a None one dropped."""
    if "extra_agg" in inspect.signature(fn).parameters:
        return fn

    @functools.wraps(fn)
    def call(*args, extra_agg=None, **kw):
        if extra_agg is not None:
            raise ValueError("the parent tree's GraphNetBlock kernels take no extra_agg")
        return fn(*args, **kw)
    return call


@functools.lru_cache(maxsize=None)
def with_receivers(fn):
    """An attention wrapper called as this tree's are, (q, k, v, senders,
    receivers, edge_mask, layout): a parent tree's NK wrapper that takes no
    receivers gets them dropped."""
    if "receivers" in inspect.signature(fn).parameters:
        return fn
    return functools.wraps(fn)(
        lambda q, k, v, senders, receivers, edge_mask, layout: fn(q, k, v, senders, edge_mask,
                                                                   layout))


def gn_libs(layout, h, backward):
    """The libraries of rows 1-4 (``layout``'s, at width ``h``) a call's
    parent turns take: the forward's, and with ``backward`` the
    backward's; none below hidden 64, where this tree kept the parent's
    kernels."""
    if h not in (64, 128):
        return ()
    return (f"gn_{layout}_fwd{h}",) + ((f"gn_{layout}_bwd{h}",) if backward else ())


def late(fn):
    """``fn``, an op module's wrapper, looked up by name at every call, so
    that inside ``parent_kernels`` the call goes through the parent tree's
    wrapper (``PARENT_OWN_OPS``)."""
    module, name = sys.modules[fn.__module__], fn.__name__
    return lambda *a, **kw: getattr(module, name)(*a, **kw)


def scratch_note(label, layout, h, n, b, rows, fe, depths):
    """Logs the bytes of the wide backward's bf16 scratch at this shape
    (``gnw_bwd_sizes``), this tree's and with a parent tree the parent's;
    returns (ours, parent's or None)."""
    import ctypes

    from graph_physics_tpu_torch.ops import kernel_build

    name = f"gn_{layout}_bwd{h}"
    libs = {"this tree": kernel_build._libs[name]}
    if PARENT is not None:
        libs["parent tree"] = parent_library(name)
    sizes = {}
    for tree, lib in libs.items():
        lib.gnw_bwd_sizes.restype = ctypes.c_longlong
        sizes[tree] = 2 * lib.gnw_bwd_sizes(0, n, b, rows, fe, *depths)
    log(f"{label}: the backward's bf16 scratch (gnw_bwd_sizes) "
        + ", ".join(f"{tree} {v} bytes ({v / 2**30:.4f} GiB)" for tree, v in sizes.items()))
    return sizes["this tree"], sizes.get("parent tree")


def timed(fn, libs, device=False, device_reps=20, **kw):
    """{"ms": CUDA-event median (``kw`` to cuda_ms), "device_ms": the
    profiler's sum over ``device_reps`` calls (with ``device``)}; with a
    parent tree the same under "parent_ms" and "parent_device_ms", taken
    in turns on the card with the parent's ``libs``: parent, this tree,
    this tree, parent, each number the mean of its pair."""
    def measure():
        out = {"ms": cuda_ms(fn, **kw)}
        if device:
            out["device_ms"] = device_ms(fn, reps=device_reps)
        return out

    if PARENT is None or not libs:
        return measure()
    with parent_kernels(*libs):
        p1 = measure()
    c1, c2 = measure(), measure()
    with parent_kernels(*libs):
        p2 = measure()
    out = {k: (c1[k] + c2[k]) / 2 for k in c1}
    out.update({f"parent_{k}": (p1[k] + p2[k]) / 2 for k in p1})
    return out


def attention_backward(ops, qkv, rows, layout, cot):
    """One backward of a layout's attention (``ops``, its op module), for
    ``timed``: autograd through a graph built on first use by whatever the
    op module's wrapper is then (this tree's, or the parent's in its turns
    under ``--parent``), one graph for each, retained."""
    import torch

    name = ops.__name__.rsplit(".", 1)[-1]
    graphs = {}

    def run():
        fn = getattr(ops, name)
        if fn not in graphs:
            leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
            graphs[fn] = (fn(*leaves, *rows, layout), leaves)
        out, leaves = graphs[fn]
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)

    return run


def check_kept_stats(label, kernels, qkv, rows, layout, out):
    """The forward kernel of ``kernels`` keeping its statistics (as under
    autograd) gives ``out`` again, and its max and 1/denominator match
    their plain version (``softmax_stats``): the max to the logits' fp32
    sum order, 1/denominator to a bf16 weight rounded the other way; -inf
    and 0 exactly where a receiver has no valid row; at head widths 8 and
    below the fp32 output it also keeps rounds to ``out``."""
    import torch
    from graph_physics_tpu_torch.ops.fused_edge_attention_csr import softmax_stats

    kept, (m_k, inv_k, *out32) = kernels[0](*qkv, *rows, layout, keep_stats=True)
    m_p, inv_p = softmax_stats(*qkv[:2], *rows)
    if not torch.equal(kept, out) or not all(torch.equal(o.to(torch.bfloat16), out)
                                             for o in out32):
        raise AssertionError(f"{label}: the forward keeping its statistics gives another "
                             "output")
    has_rows = torch.isfinite(m_p)
    compare("kept max logit", m_k, m_p, STATS_MAX_TOL, rows=has_rows)
    compare("kept 1/denominator", inv_k, inv_p, STATS_INV_RTOL, rows=has_rows, atol=0.0)
    if not torch.equal(torch.isinf(m_k), ~has_rows) or (inv_k[~has_rows] != 0).any():
        raise AssertionError(f"{label}: the kept max and 1/denominator are not -inf and 0 "
                             "exactly where a receiver has no valid row")


def same_bits_as_parent(label, fn, libs):
    """With a parent tree, raises unless ``fn()`` (a tensor or a sequence of
    them) gives the same bits with the parent's ``libs`` as with this
    tree's."""
    import torch

    if PARENT is None:
        return
    ours = fn()
    with parent_kernels(*libs):
        theirs = fn()
    ours, theirs = ((t,) if torch.is_tensor(t) else tuple(t) for t in (ours, theirs))
    if not all(torch.equal(a, b) for a, b in zip(ours, theirs)):
        raise AssertionError(f"{label}: other bits than the parent tree's kernels")
    log(f"  {label}: the same bits as the parent tree's kernels")


def parent_note(t):
    """The parent tree's times in ``timed``'s result, for a log line."""
    if "parent_ms" not in t:
        return ""
    dev = f" (device {t['parent_device_ms']:.4f})" if "parent_device_ms" in t else ""
    return f"; parent tree {t['parent_ms']:.4f} ms{dev}"


def backward_times(label, fn, plain_fn, libs, card):
    """A GraphNetBlock backward variant's times: ``timed``'s CUDA-event ms
    of ``fn`` (one autograd call through the kernel), the plain backward's
    (``plain_fn``), and the device time by pass, whose sum is its device
    time; the parent tree's too."""
    t = dict(timed(fn, libs), plain_ms=cuda_ms(plain_fn), passes=pass_split(fn))
    t["device_ms"] = sum(t["passes"].values())
    splits = {"kernel": t["passes"]}
    if PARENT is not None and libs:
        with parent_kernels(*libs):
            splits["parent tree"] = pass_split(fn)
        t["parent_device_ms"] = sum(splits["parent tree"].values())
    parent = (f"; parent tree {t['parent_ms']:.4f} ms (device {t['parent_device_ms']:.4f})"
              if PARENT is not None and libs else "")
    log(f"  backward time: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
        f"{t['plain_ms']:.4f} ms{parent} ({card})")
    for tree, split in splits.items():
        log(f"  {label} device ms by pass, {tree}: "
            + ", ".join(f"{p} {ms:.4f}" for p, ms in sorted(split.items(), key=lambda kv: -kv[1])))
    return t


def check_rollouts(label, res, res_plain):
    """Logs both rollouts' per-trajectory RMSEs; raises unless both are
    finite and the RMSEs agree within ROLLOUT_RTOL."""
    import torch

    rk, rp = res.rmse_all_rollout.tolist(), res_plain.rmse_all_rollout.tolist()
    log(f"{label} rollout rmse_all_rollout (R={ROLLOUT_WINDOWS}, T={ROLLOUT_STEPS}), kernel "
        "path: " + " ".join(f"{v:.6g}" for v in rk))
    log(f"{label} rollout rmse_all_rollout, plain path:  " + " ".join(f"{v:.6g}" for v in rp))
    for name, r in (("kernel", res), ("plain", res_plain)):
        if not (torch.isfinite(r.predictions).all() and torch.isfinite(r.rmse_all_rollout).all()):
            raise AssertionError(f"{label} rollout ({name} path): non-finite values")
    worst = max(abs(a - c) / abs(c) for a, c in zip(rk, rp))
    log(f"  rollout rmse max relative difference {worst:.6g} (limit {ROLLOUT_RTOL})")
    if worst > ROLLOUT_RTOL:
        raise AssertionError(f"{label} rollout RMSE differs by {worst:.4g} relative")


def log_grad_rows(rows):
    """The streams (activation gradients) in full; the weight gradients as
    their worst values; any row out of bounds in full."""
    def line(r):
        if not r.get("finite", True):
            return f"  {r['name']}: non-finite values"
        extra = (f" {r['outside']} of {r['count']} outside rtol=atol=0.05 (the fp32 gradient: "
                 f"{r['fp32_outside']});" if "outside" in r else "")
        return (f"  {r['name']}: max_abs_err {r['max_abs_err']:.6g} |a-b|/max|b| "
                f"{r['rel_to_max']:.6g};{extra} vs fp32: rel L2 kernel {r['kernel_fp32_l2']:.6g} "
                f"plain {r['plain_fp32_l2']:.6g}, max/|max| kernel {r['kernel_fp32_max']:.6g} "
                f"plain {r['plain_fp32_max']:.6g}{'' if r['ok'] else '  <-- OUT OF BOUNDS'}")

    weights = [r for r in rows if "outside" not in r and r.get("finite", True)]
    for r in rows:
        if "outside" in r or not r["ok"]:
            log(line(r))
    if weights:
        def worst(key):
            return max(weights, key=key)

        w = worst(lambda r: r["rel_to_max"])
        l2 = worst(lambda r: r["kernel_fp32_l2"] / max(r["plain_fp32_l2"], 1e-30))
        mx = worst(lambda r: r["kernel_fp32_max"] / max(r["plain_fp32_max"], 1e-30))
        log(f"  {len(weights)} weight gradients: worst |a-b|/max|b| {w['rel_to_max']:.6g} "
            f"({w['name']}); vs fp32, worst kernel/plain rel L2 {l2['kernel_fp32_l2']:.6g}/"
            f"{l2['plain_fp32_l2']:.6g} ({l2['name']}), max {mx['kernel_fp32_max']:.6g}/"
            f"{mx['plain_fp32_max']:.6g} ({mx['name']})")


def launch_counts(k):
    """(forward, backward) launches of a wrapper; a wrapper whose gradient
    needs no kernel has no backward count."""
    return k.launches, getattr(k, "backward_launches", 0)


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0
        if hasattr(k, "backward_launches"):
            k.backward_launches = 0


def batch_size(graph):
    """B of a packed [N, B, F] or stacked [B, N, F] batch."""
    return graph.x.shape[0] if graph.node_type.ndim == 2 else graph.x.shape[1]


def plain_copy(sim):
    """A copy of ``sim`` on the plain path: no edge layout, or, for a
    Transolver, the gumbel kernel's plain version on the same bits."""
    from graph_physics_tpu_torch.models.processors import TransolverProcessor
    from graph_physics_tpu_torch.models.transolver import use_plain_gumbel

    sim = copy.deepcopy(sim)
    if isinstance(sim.model, TransolverProcessor):
        return use_plain_gumbel(sim)
    sim.model.tiling = None
    return sim


def train_run(step, state, sim, graph, seed, n_steps, kernels=()):
    """``n_steps`` train steps of ``sim`` with noise from a generator seeded
    with ``seed``; returns (losses, grad norms, launches per step of each
    wrapper in ``kernels`` as (forward, backward) pairs, the unclipped
    gradients of step 1 by parameter name, and each step's loss terms)."""
    import torch

    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    params = dict(sim.named_parameters())
    losses, norms, launches, grads, terms = [], [], [], None, []
    for i in range(1, n_steps + 1):
        before = [launch_counts(k) for k in kernels]
        m = step(state, graph, gen)
        after = [launch_counts(k) for k in kernels]
        launches.append(tuple((f1 - f0, b1 - b0) for (f0, b0), (f1, b1) in zip(before, after)))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        terms.append([m[f"loss_term_{t}"].item() for t in range(len(m) - 2)])
        if i == 1:  # undo the clip: g · min(1, clip / norm)
            undo = max(norms[-1] / state.optimizer.grad_clip, 1.0)
            grads = {k: p.grad.float() * undo for k, p in params.items()}
    return losses, norms, launches, grads, terms


def training_phase(label, train, kernels, seed, per_step_want=None, steps=None):
    """``steps`` (``TRAIN_STEPS``) steps of ``train`` (an entry train setup) on the
    kernel path, counts set to 0 just before, against the same steps on a
    copy whose blocks all take the plain path (``plain_copy``), from the
    same weights and noise. Every wrapper in ``kernels`` must launch
    ``per_step_want`` (forward, backward) times a step, by default once
    forward and once backward per block; the step-1 loss and gradients and
    the later losses must agree. Returns (plain simulator, its state and
    step, {wrapper name: (forward, backward) launches in all})."""
    import torch
    from graph_physics_tpu_torch import entry

    tgraph = train.graph
    steps = steps or TRAIN_STEPS
    if per_step_want is None:
        n_blocks = len(train.simulator.model.processor_list)
        per_step_want = (n_blocks, n_blocks)
    plain_sim = plain_copy(train.simulator)
    preprocess = getattr(train, "device_preprocess", None)
    loss_fn, method = getattr(train, "loss_fn", None), getattr(train, "gradient_method", None)
    plain_state, plain_step = entry.make_trainer(plain_sim, preprocess, loss_fn, method)
    fg = step1_fp32_grads(plain_sim, tgraph, seed, preprocess, loss_fn, method)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    kl, kn, per_step, kg, kt = train_run(train.train_step, train.state, train.simulator, tgraph,
                                         seed, steps, kernels)
    torch.cuda.synchronize()
    launches = {k.__name__: launch_counts(k) for k in kernels}
    peak = {"kernel": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    pl, pn, _, pg, pt = train_run(plain_step, plain_state, plain_sim, tgraph, seed, steps)
    torch.cuda.synchronize()
    peak["plain"] = torch.cuda.max_memory_allocated()
    log(f"{label} ({steps} steps, B={batch_size(tgraph)}): launches per step "
        f"(forward, backward) of {', '.join(launches)}: {sorted(set(per_step))}; in all "
        f"{list(launches.values())}; max_memory_allocated kernel path "
        f"{peak['kernel'] / 2**30:.4f} GiB, plain path {peak['plain'] / 2**30:.4f} GiB")
    log("  loss, kernel path:      " + " ".join(f"{v:.6g}" for v in kl))
    log("  loss, plain path:       " + " ".join(f"{v:.6g}" for v in pl))
    log("  grad_norm, kernel path: " + " ".join(f"{v:.6g}" for v in kn))
    log("  grad_norm, plain path:  " + " ".join(f"{v:.6g}" for v in pn))
    want = tuple(per_step_want for _ in kernels)
    if any(s != want for s in per_step):
        raise AssertionError(f"{label}: expected {per_step_want} (forward, backward) launches "
                             f"of each kernel per train step, got {per_step}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), kl + kn + pl + pn)):
        raise AssertionError(f"{label}: non-finite loss or gradient norm")
    loss_rel = [abs(a - c) / abs(c) for a, c in zip(kl, pl)]
    log(f"  loss relative difference: step 1 {loss_rel[0]:.6g} (limit {STEP1_LOSS_RTOL}), "
        f"steps 2-{steps} max {max(loss_rel[1:]):.6g} (limit {LATER_LOSS_RTOL})")
    names = sorted(pg)
    if sorted(kg) != names or sorted(fg) != names:
        raise AssertionError(f"{label}: the paths have gradients for different parameters")
    flat = {k: torch.cat([g[n].flatten() for n in names]) for k, g in
            (("kernel", kg), ("plain", pg), ("fp32", fg))}
    grad_rel = ((flat["kernel"] - flat["plain"]).abs().max()
                / flat["plain"].abs().max()).item()
    per_param = {n: ((kg[n] - pg[n]).abs().max() / pg[n].abs().max().clamp_min(1e-30)).item()
                 for n in names}
    worst = max(per_param, key=per_param.get)
    l2 = {k: ((flat[k] - flat["fp32"]).norm() / flat["fp32"].norm()).item()
          for k in ("kernel", "plain")}
    log(f"  step-1 gradients over {len(names)} parameters: max |a-b| / max|b| {grad_rel:.6g} "
        f"(limit {STEP1_GRAD_REL}); per parameter at most {per_param[worst]:.6g} ({worst}); "
        f"rel L2 against the fp32 plain path: kernel path {l2['kernel']:.6g}, "
        f"plain path {l2['plain']:.6g}")
    if loss_rel[0] > STEP1_LOSS_RTOL or max(loss_rel[1:]) > LATER_LOSS_RTOL:
        raise AssertionError(f"{label}: loss of the kernel path is off the plain path's")
    if len(kt[0]) > 1:  # a MultiLoss: each term to the loss's bounds
        for t in range(len(kt[0])):
            rel = [abs(a[t] - c[t]) / abs(c[t]) for a, c in zip(kt, pt)]
            log(f"  loss term {t}: kernel path step 1 {kt[0][t]:.6g}, plain {pt[0][t]:.6g}; "
                f"relative difference step 1 {rel[0]:.6g}, steps 2-{steps} max "
                f"{max(rel[1:]):.6g}")
            if rel[0] > STEP1_LOSS_RTOL or max(rel[1:]) > LATER_LOSS_RTOL:
                raise AssertionError(f"{label}: loss term {t} of the kernel path is off the "
                                     "plain path's")
    if grad_rel > STEP1_GRAD_REL:
        raise AssertionError(f"{label}: step-1 gradients off the plain path's")
    for k, p in train.simulator.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{label}: parameter {k} is not finite")
    return plain_sim, plain_state, plain_step, launches


def step_timing(train, plain_state, plain_step, seed, libs=()):
    """Whether ``train``'s step (an entry train setup) is bound by the
    host: the host's time to enqueue one step from a synchronised start,
    with the CUDA-event time of the same calls, taken before any profiler
    session of the phase. Then the CUDA-event medians of the step and of
    the plain path's, the kernel path's device time a step (the profiler's
    sum of its kernels, ``device_ms``), and the device-to-host
    synchronisations one step makes (logged, not bounded). With a parent
    tree, its step with the parent's ``libs`` too (``timed``). A
    ``plain_step`` of None leaves the plain path's time out."""
    import torch

    graph = train.graph
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    for _ in range(2):
        train.train_step(train.state, graph, gen)
    enqueue, events = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        train.train_step(train.state, graph, gen)
        enqueue.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    t = timed(lambda: train.train_step(train.state, graph, gen), libs, device=True,
              device_reps=5, warmup=2, reps=10)
    out = {f"train_step_{k}": v for k, v in t.items()}
    if plain_step is not None:
        out["train_step_plain_ms"] = cuda_ms(lambda: plain_step(plain_state, graph, gen),
                                             warmup=2, reps=10)
    out["train_step_enqueue_events_ms"] = statistics.median(events)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        train.train_step(train.state, graph, gen)
    torch.cuda.set_sync_debug_mode("default")
    out["train_step_host_enqueue_ms"] = statistics.median(enqueue)
    out["train_step_syncs"] = len(syncs)
    return out


def parent_step_note(st):
    return parent_note({k[len("train_step_"):]: v for k, v in st.items()
                        if k.startswith("train_step_parent")})


def step1_fp32_grads(sim, graph, seed, preprocess=None, loss_fn=None, gradient_method=None):
    """Gradients of the first train step's loss (same noise draws, slice
    noise too; ``preprocess`` in place of bench.py's noise where the setup
    has one; ``loss_fn``, a MultiLoss, with ``gradient_method`` in place of
    the masked L2) on an fp32 copy of ``sim`` on the plain path, by
    parameter name."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.training.loss import DEFAULT_MASK_TYPES, l2_loss
    from graph_physics_tpu_torch.training.noise import add_noise
    from graph_physics_tpu_torch.training.step import model_uses_gumbel, multi_loss

    sim = plain_copy(sim)
    for m in sim.modules():  # modules that cast to a compute dtype
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    cfg = entry.NOISE
    g = (preprocess(graph, gen, 0) if preprocess is not None
         else add_noise(graph, gen, cfg.starts, cfg.ends, cfg.scales))
    with torch.enable_grad():
        out = sim.forward(g, is_training=True,
                          gumbel=gen if model_uses_gumbel(sim.model) else None)
        if loss_fn is None:
            l2_loss(g, out.net_out, out.target_norm).backward()
        else:
            multi_loss(loss_fn, sim, g, out, DEFAULT_MASK_TYPES, gradient_method)[0].backward()
    return {k: p.grad.float() for k, p in sim.named_parameters()}


#: the trainer phases (25-28): bench.py's batch of 128 frames a step, 8
#: training trajectories of 129 frames (128 samples each, so one batch a
#: trajectory and 8 steps an epoch), 3 epochs, 1 validation trajectory of
#: 50 rollout steps
FIT_TRAJECTORIES, FIT_FRAMES, FIT_BATCH, FIT_EPOCHS = 8, 129, 128, 3
VAL_STEPS = 50
#: the synthetic cylinder mesh of every setup (1,920 nodes)
FIT_MESH = (48, 40)
#: phase 26b: the transformer at bench_models.py's B=64, one epoch
TF_FIT_BATCH = 64


def memory_dataset_class():
    """A BaseDataset over trajectory dicts held in memory (the card's
    machine has no h5py, so no H5Dataset); ``partitions`` (num_partitions,
    max_nodes_per_partition) go to BaseDataset."""
    from graph_physics_tpu_torch.dataset.base import BaseDataset

    class MemoryDataset(BaseDataset):
        def __init__(self, trajectories, meta, frame_config, seed=0, **partitions):
            super().__init__(frame_config, meta, seed=seed, **partitions)
            self._trajs = list(trajectories)
            self._traj_len = [int(next(t[k] for k in ("velocity", "world_pos", "Vitesse")
                                       if k in t).shape[0]) for t in self._trajs]
            self._setup_index()

        @property
        def num_trajectories(self):
            return len(self._trajs)

        def _trajectory(self, t):
            return self._trajs[t]

    return MemoryDataset


def fit_datasets(trajectories=FIT_TRAJECTORIES):
    """(training, validation) in-memory datasets of synthetic cylinder
    trajectories (48 x 40 mesh, 1,920 nodes)."""
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig

    ds = memory_dataset_class()
    fc = FrameConfig(targets=("velocity",))
    train = ds([synthetic.make_trajectory(*FIT_MESH, FIT_FRAMES)] * trajectories,
               synthetic.meta_dict(FIT_FRAMES), fc)
    val = ds([synthetic.make_trajectory(*FIT_MESH, VAL_STEPS + 1)],
             synthetic.meta_dict(VAL_STEPS + 1), fc)
    return train, val


def cylinder_param():
    from graph_physics_tpu_torch.training import config as config_lib

    return config_lib.load_params(str(ROOT / "training_config" / "cylinder.json"))


def fit_trainer(param, train_ds, val_ds, run, device, batch=None, epochs=None, fresh=True,
                fused=True, world_pos=None):
    """A Trainer of the config ``param``'s model (bf16, weights from seed 0
    as the CLI draws them) on the packed batches of the fused path (the
    plain path with ``fused=False``), with the world-position edge
    features ``world_pos`` (a WorldPosConfig) where given; with ``fresh``
    the run's directory (checkpoints, metrics) starts empty."""
    import torch
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.loss import l2_loss
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig

    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
    lecun_parameters(sim, torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=epochs or FIT_EPOCHS, batch_size=batch or FIT_BATCH,
                        learning_rate=1e-3, warmup=100,
                        packed=True, fused=fused, out_dir=str(ROOT / "build" / "fit"),
                        run_name=run, seed=0)
    if fresh:
        shutil.rmtree(ROOT / "build" / "fit" / run, ignore_errors=True)
    return Trainer(sim, train_ds, val_ds, l2_loss, cfg,
                   noise_cfg=config_lib.get_noise_config(param), world_pos=world_pos,
                   device=device)


def data_phase(device, train_ds):
    """Phase 25: every batch the loader delivers to the card equals its
    numpy source bit for bit, on the vectorized lane and frame by frame,
    for two epochs (the first batch of a trajectory always builds frame by
    frame and makes the lane's skeleton and layout template)."""
    import numpy as np
    import torch
    from graph_physics_tpu_torch.core.graph import TENSOR_FIELDS
    from graph_physics_tpu_torch.dataset.loader import BatchLoader
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager

    for lane in ("vectorized", "per-frame"):
        mgr = FusedTopologyManager("epd")
        loader = BatchLoader(train_ds, FIT_BATCH, seed=0, packed=True, device=device,
                             frame_transform=mgr.transform_frame,
                             packed_transform=mgr.transform_packed, broadcast_static=True)
        sources, fast = [], [0]
        host_batch, packed_fast = loader.host_batch, loader._packed_fast

        def recording(chunk, host_batch=host_batch):
            sources.append(host_batch(chunk))
            return sources[-1]

        def counting(chunk, packed_fast=packed_fast, lane=lane):
            g = packed_fast(chunk) if lane == "vectorized" else None
            fast[0] += g is not None
            return g

        loader.host_batch, loader._packed_fast = recording, counting
        n = 0
        for epoch in range(2):
            for batch in loader:
                src = sources[n]
                for name in TENSOR_FIELDS:
                    got, want = getattr(batch, name), getattr(src, name)
                    if (got is None) != (want is None):
                        raise AssertionError(f"phase 25 [{lane}]: {name} None on one side")
                    if got is not None and not torch.equal(
                            got.cpu(), torch.as_tensor(np.asarray(want)).to(got.dtype)):
                        raise AssertionError(f"phase 25 [{lane}] batch {n}: {name} differs "
                                             "from its numpy source")
                    if got is not None and got.device != torch.device(device):
                        raise AssertionError(f"phase 25: {name} is not on the card")
                n += 1
        log(f"data [{lane}]: {n} batches of {FIT_BATCH} frames delivered to {device} equal "
            f"their numpy sources bit for bit ({fast[0]} built on the vectorized lane)")
        if n != 2 * len(loader) or (lane == "vectorized") != (fast[0] > 0):
            raise AssertionError(f"phase 25 [{lane}]: {n} batches, {fast[0]} vectorized")


def interval_ms(fn, calls):
    """Median milliseconds between the starts of ``calls`` back-to-back
    calls of ``fn`` (CUDA events, no sync between calls), as
    :func:`fit_step_times` reads the steps inside fit."""
    import torch

    marks = []
    for _ in range(calls):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        fn()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))


def fit_step_times(trainer):
    """Wrap ``trainer.train_step`` to record a CUDA event as each step
    starts; returns {epoch: [event, ...]}."""
    import torch

    marks, inner = defaultdict(list), trainer.train_step

    def step(state, batch, gen):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[state.step // trainer.steps_per_epoch].append(ev)
        return inner(state, batch, gen)

    trainer.train_step = step
    return marks


def trainer_state(trainer):
    """Parameters, normalizer accumulators, optimizer moments and count, step."""
    out = {k: v.detach().clone() for k, v in trainer.sim.state_dict().items()}
    opt = trainer.state.optimizer
    for i, p in enumerate(opt.params):
        for k, v in opt.adamw.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v.detach().clone()
    out["count"], out["step"] = opt.count, trainer.state.step
    return out


def state_diff(a, b):
    """(largest relative difference, its part, every part's) between two
    trainer states; 0 when every tensor is equal bit for bit. The parts: the parameters,
    the normalizer accumulators, Adam's first and second moments, each as
    one vector by ||b - a|| / ||a|| (a single small tensor, a bias that
    started at 0, moves by rounding alone); the update count, the step and
    Adam's own step counts must be equal."""
    import torch

    if set(a) != set(b):
        raise AssertionError("phase 27: the states hold different tensors")
    a = {k: torch.as_tensor(v).float() for k, v in a.items()}
    b = {k: torch.as_tensor(v).float() for k, v in b.items()}
    if all(torch.equal(a[k], b[k]) for k in a):
        return 0.0, "all", {}
    parts = {"parameters": [], "normalizers": [], "exp_avg": [], "exp_avg_sq": []}
    diffs = {}
    for k in a:
        if k.endswith(".exp_avg") or k.endswith(".exp_avg_sq"):
            parts[k.rsplit(".", 1)[1]].append(k)
        elif k in ("count", "step") or k.startswith("opt."):
            diffs[k] = 0.0 if torch.equal(a[k], b[k]) else float("inf")
        else:
            parts["normalizers" if "_normalizer." in k else "parameters"].append(k)
    for part, names in parts.items():
        va, vb = (torch.cat([s[k].flatten() for k in names]) for s in (a, b))
        diffs[part] = ((vb - va).norm() / va.norm().clamp_min(1e-30)).item()
    worst = max(diffs, key=diffs.get)
    return diffs[worst], worst, {k: diffs[k] for k in parts}


def epoch_records(trainer):
    path = Path(trainer.cfg.out_dir) / trainer.cfg.run_name / f"{trainer.cfg.run_name}.metrics.jsonl"
    return [r for r in map(json.loads, path.read_text().splitlines()) if "train_loss_epoch" in r]


def trainer_phases(device, card, entry_step_ms):
    """Phases 25-28 (the trainer, its loader, checkpoint and predict);
    returns {wrapper name: (forward, backward) launches} of phases 26 and
    26b, each read right after its run with the counts set to 0 just
    before it."""
    import torch
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    gn = nk_ops.fused_gn_block_nk
    attn, ffn = ea_ops.fused_edge_attention_nk, ffn_ops.fused_gated_ffn
    train_ds, val_ds = fit_datasets()
    data_phase(device, train_ds)

    # 26. fit of cylinder.json's model through the port's Trainer; first the
    # entry step, timed as fit's steps are read
    from graph_physics_tpu_torch import entry

    es = entry.cylinder_train_setup(device, batch=FIT_BATCH, nx=FIT_MESH[0], ny=FIT_MESH[1])
    gen = torch.Generator(device=device).manual_seed(0)
    entry_interval = interval_ms(lambda: es.train_step(es.state, es.graph, gen), 17)
    del es
    param = cylinder_param()
    tr = fit_trainer(param, train_ds, val_ds, "fit", device)
    marks = fit_step_times(tr)
    reset_counts([gn, attn, ffn])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {gn.__name__: launch_counts(gn)}
    steps = tr.state.step
    n_blocks = len(tr.sim.model.processor_list)
    records = epoch_records(tr)
    intervals = [a.elapsed_time(b) for e in sorted(marks) if e > 0
                 for a, b in zip(marks[e], marks[e][1:])]
    fit_step_ms = statistics.median(intervals)
    log(f"fit (cylinder.json: {n_blocks} blocks, hidden {tr.sim.model.hidden_size}, bf16, "
        f"{type(tr.sim.model.tiling).__name__} layout; {FIT_TRAJECTORIES} trajectories of "
        f"{FIT_FRAMES} frames, B={FIT_BATCH}, {FIT_EPOCHS} epochs, {steps} steps, validation "
        f"{VAL_STEPS} rollout steps): {fit_s:.1f} s")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} val_loss {r['val_loss']:.6g} "
            f"({r['epoch_time_s']:.2f} s)")
    log(f"  launches (forward, backward) of {gn.__name__}: {launches[gn.__name__]}; "
        f"{n_blocks} + {n_blocks} a step over {steps} steps and {n_blocks} a rollout step")
    log(f"  steady-state step inside fit (epochs 2-{FIT_EPOCHS}, start to start, median of "
        f"{len(intervals)}): {fit_step_ms:.4f} ms ({1000 * FIT_BATCH / fit_step_ms:.1f} "
        f"graph-steps/s); entry.cylinder_train_setup's step, read the same way: "
        f"{entry_interval:.4f} ms (phase 8, synchronised per step: {entry_step_ms:.4f}) "
        f"({card})")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if len(records) != FIT_EPOCHS or not all(math.isfinite(v) for v in values):
        raise AssertionError("phase 26: an epoch's loss or rollout RMSE is not finite")
    want = (n_blocks * (steps + FIT_EPOCHS * VAL_STEPS), n_blocks * steps)
    if steps != FIT_EPOCHS * len(tr._loader(0)) or launches[gn.__name__] != want:
        raise AssertionError(f"phase 26: {steps} steps, launches {launches[gn.__name__]}, "
                             f"expected {want}")
    straight = trainer_state(tr)
    # the same step on batches already on the card, no loader running: the
    # fit step's cost beyond the entry step, without the loader's share
    batches = list(tr._loader(FIT_EPOCHS))
    cycle = itertools.cycle(batches)
    resident_ms = interval_ms(lambda: tr.train_step(tr.state, next(cycle),
                                                    tr._generator(tr.state.step)),
                              2 * len(batches))
    one_ms = interval_ms(lambda: tr.train_step(tr.state, batches[0],
                                               tr._generator(tr.state.step)), 2 * len(batches))
    log(f"  the same step on the {len(batches)} batches of an epoch already on the card (no "
        f"loader running; start to start, median of {2 * len(batches) - 1}): "
        f"{resident_ms:.4f} ms; on one of them every step: {one_ms:.4f} ms ({card})")
    del batches, cycle

    # 26b. the transformer, one epoch through fit
    tf_param = json.loads(json.dumps(param))
    tf_param["model"] = {"type": "transformer", "message_passing_num": 2, "hidden_size": 64,
                         "num_heads": 4, "node_input_size": 2, "output_size": 2,
                         "edge_input_size": 0}
    ttr = fit_trainer(tf_param, train_ds, val_ds, "fit_transformer", device,
                      batch=TF_FIT_BATCH, epochs=1)
    reset_counts([gn, attn, ffn])
    ttr.fit()
    torch.cuda.synchronize()
    for k in (attn, ffn):
        launches[k.__name__] = launch_counts(k)
    tsteps = ttr.state.step
    rec = epoch_records(ttr)[-1]
    log(f"fit, transformer (2 blocks, hidden 64, 4 heads, bf16, B={TF_FIT_BATCH}, 1 epoch, "
        f"{tsteps} steps): train_loss_epoch {rec['train_loss_epoch']:.6g} "
        f"val_all_rollout_rmse {rec['val_all_rollout_rmse']:.6g}; launches (forward, backward) "
        + ", ".join(f"{k.__name__} {launches[k.__name__]}" for k in (attn, ffn)))
    want = (2 * (tsteps + VAL_STEPS), 2 * tsteps)
    if any(launches[k.__name__] != want for k in (attn, ffn)) or not math.isfinite(
            rec["val_all_rollout_rmse"]) or gn.launches:
        raise AssertionError(f"phase 26b: expected {want} launches of each kernel, got "
                             f"{launches}")

    # 27. checkpoint: stop after epoch 2, resume from the checkpoint, finish,
    # against an uninterrupted run made the same way (a fresh trainer after
    # the same phases): on the plain path in PyTorch's default mode (its
    # sums add in a fixed order, ops/segment.py), bit for bit; on the
    # kernel path within RESUME_REL
    def resume_against_uninterrupted(tag, fused):
        first = fit_trainer(param, train_ds, val_ds, f"fit_resumed{tag}", device, fused=fused)
        first.fit(stop_after_epochs=FIT_EPOCHS - 1)
        second = fit_trainer(param, train_ds, val_ds, f"fit_resumed{tag}", device, fresh=False,
                             fused=fused)
        with torch.no_grad():  # other weights: the checkpoint must bring them back
            for p in second.sim.parameters():
                p.add_(1.0)
        second.fit(resume=True)
        again = fit_trainer(param, train_ds, val_ds, f"fit_again{tag}", device, fused=fused)
        again.fit()
        torch.cuda.synchronize()
        return first.state.step, trainer_state(second), trainer_state(again)

    def parts(d):
        return ", ".join(f"{k} {v:.3g}" for k, v in d.items())

    at, resumed, uninterrupted = resume_against_uninterrupted("_plain", False)
    plain_rel, plain_at, plain_parts = state_diff(uninterrupted, resumed)
    log(f"checkpoint, plain path, default mode: {FIT_EPOCHS - 1} epochs, resume "
        f"from step {at}, 1 epoch: {len(resumed)} tensors (parameters, normalizer "
        f"accumulators, optimizer moments and count, step) against an uninterrupted run's: "
        + ("equal bit for bit" if plain_rel == 0.0 else
           f"differ: {plain_rel:.6g} ({plain_at}; {parts(plain_parts)})"))
    at, resumed, uninterrupted = resume_against_uninterrupted("", True)
    resume_rel, resume_at, resume_parts = state_diff(uninterrupted, resumed)
    spread_rel, spread_at, spread_parts = state_diff(straight, uninterrupted)
    exact = resume_rel == 0.0
    log(f"checkpoint, kernel path: resume from step {at} against an uninterrupted run's: "
        + ("equal bit for bit" if exact else
           f"at most {resume_rel:.6g} relative ({resume_at}; limit {RESUME_REL}; "
           f"{parts(resume_parts)})")
        + f"; phase 26's run against the uninterrupted one: {spread_rel:.6g} ({spread_at}; "
        f"{parts(spread_parts)})")
    if (plain_rel != 0.0 or set(resumed) != set(straight) or resume_rel > RESUME_REL
            or (spread_rel == 0.0 and not exact)):
        raise AssertionError("phase 27: the resumed run is off the uninterrupted run")

    # 28. predict from phase 26's checkpoint, the dataset passed in
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(ROOT / "training_config" / "cylinder.json"),
        "--model_path", tr.ckpt_dir, "--bf16", "--fused", "--device", str(device)])
    before = gn.launches
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    log(f"predict: checkpoint step {stack.step}, rollout of {pred.predictions.shape[0]} steps "
        f"({gn.launches - before} launches): rmse_all_rollout {pred.rmse_all_rollout:.8g}, "
        f"validate reported {want_rmse:.8g} (relative difference {rel:.3g}, limit "
        f"{PREDICT_RTOL})")
    if stack.step != steps or rel > PREDICT_RTOL or gn.launches - before != n_blocks * VAL_STEPS:
        raise AssertionError("phase 28: predict's rollout is not validate's")
    return launches, {"fit_step_ms": fit_step_ms, "resident_step_ms": resident_ms,
                      "one_batch_step_ms": one_ms,
                      "entry_step_ms": entry_interval, "entry_step_synced_ms": entry_step_ms,
                      "resume_bit_exact": exact, "resume_max_rel": resume_rel,
                      "spread_max_rel": spread_rel}


def main():
    global PARENT
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; it needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        PARENT = Path(sys.argv[2]).resolve()
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--parent CHECKOUT]")
    sys.path.insert(0, str(ROOT))
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.ops import kernel_build
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
    from graph_physics_tpu_torch.utils import gradcheck

    kernel = nk_ops.fused_gn_block_nk
    plain = nk_ops.fused_gn_block_nk_reference
    device = torch.device(DEVICE)
    torch.cuda.set_device(device)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. build
    t0 = time.perf_counter()
    if PARENT is not None:
        log(f"parent tree: {PARENT}")
        start_parent_builds()
    build_log = kernel_build.build()
    for name in PARENT_LIBS if PARENT is not None else ():
        parent_library(name)  # waits for its nvcc: none outlives the build phase
    libs = ", ".join(str(kernel_build.library_path(n).relative_to(ROOT))
                     for n in kernel_build.LIBRARIES)
    log(f"build: {time.perf_counter() - t0:.1f} s -> {libs}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            log(f"  {line.strip()}")
    for name, use in kernel_resources(build_log, REDESIGNED).items():
        log(f"ptxas, redesigned kernel {name}: {use}")

    # the slice: model, NK layout, packed B=128 batch, normalizer statistics
    setup = entry.cylinder_setup(device, num_steps=ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1)
    sim, graph, nk = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    log(f"slice: {n} nodes x {b} samples, hidden {hidden}, K={nk.k_slots}, "
        f"{nk.total_rows} slots ({int(graph.edge_mask.sum())} edges), "
        f"{len(model.processor_list)} blocks")

    # 3. kernel check: each variant against its plain version, same inputs
    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x_in = randn(n, b, hidden)
    e_in = randn(nk.total_rows, b, hidden)
    raw_in = randn(nk.total_rows, b, entry.EDGE_INPUT)
    blocks = model.processor_list
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    valid_slots = graph.edge_mask
    errors, timing = {}, {}
    with torch.inference_mode():
        for name, (blk, e, enc, last) in variants.items():
            args = (x_in, e, graph.senders, graph.edge_mask, blk.edge_block, blk.node_block, nk)
            kw = dict(encoder_params=enc, last_block=last)
            xk, ek = kernel(*args, **kw)
            xp, ep = plain(*args, **kw, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            log(f"kernel check [{name}]")
            err = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:  # padded slots of a folded block hold enc(raw): valid only
                err = max(err, compare("e_out", ek, ep, KERNEL_TOL,
                                       rows=valid_slots if enc is not None else None))
            errors[name] = err
            # the wrapper by name at each call: the parent's, in its turns
            t = timed(lambda: nk_ops.fused_gn_block_nk(*args, **kw), ["gn_nk_fwd"], device=True)
            timing[name] = dict(t, plain_ms=cuda_ms(lambda: plain(
                *args, **kw, compute_dtype=torch.bfloat16)))
            log(f"  time: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
                f"{timing[name]['plain_ms']:.4f} ms{parent_note(t)} ({card})")

    # 4. backward kernel check: random cotangents, padded slots included
    bwd_errors, bwd_timing, failed = {}, {}, []
    for name, (blk, e, enc, last) in variants.items():
        cot_x, cot_e = randn(n, b, hidden, scale=1.0), randn(nk.total_rows, b, hidden, scale=1.0)
        before = kernel.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x_in, e, (graph.senders, graph.edge_mask), (enc, blk.edge_block, blk.node_block),
            nk, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"backward kernel check [{name}] ({kernel.backward_launches - before} launch)")
        log_grad_rows(grad_rows)
        if kernel.backward_launches != before + 1:
            raise AssertionError(f"backward [{name}]: the backward kernel did not launch")
        if not ok:
            failed.append(name)
        bwd_errors[name] = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
        bwd_timing[name] = backward_times(
            f"NK backward [{name}]",
            lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True),
            lambda: torch.autograd.grad(*kept["plain"], retain_graph=True), ["gn_nk_bwd"], card)
        del kept
    if failed:
        raise AssertionError(f"backward kernel out of bounds for {failed}")

    # 5. slice: the packed B=128 eval forward through the kernel path
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain edge-list path
    rows = graph.node_mask
    kernel.launches = kernel.backward_launches = 0
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    forward_launches = kernel.launches
    # 6. rollout: R windows of one trajectory, T steps, kernel path
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    infer_launches = kernel.launches
    n_blocks = len(blocks)
    log(f"slice forward: {forward_launches} kernel launches ({n_blocks} blocks); "
        f"with the {ROLLOUT_STEPS}-step rollout: {infer_launches}")
    if forward_launches != n_blocks:
        raise AssertionError(f"expected {n_blocks} launches per forward, got {forward_launches}")
    if infer_launches != n_blocks * (1 + ROLLOUT_STEPS) or kernel.backward_launches:
        raise AssertionError(f"expected {n_blocks * (1 + ROLLOUT_STEPS)} forward and no "
                             f"backward launches, got {infer_launches}, "
                             f"{kernel.backward_launches}")

    out_plain = plain_sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("slice forward vs plain path (valid nodes)")
    compare("net_out", out.net_out, out_plain.net_out, SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, SLICE_TOL, rows=rows)

    check_rollouts("epd", res, make_batched_rollout_fn(plain_sim)(frames))
    log("epd rollout rmse_1step, kernel path: "
        + " ".join(f"{v:.6g}" for v in res.rmse_1step.tolist()))

    # 7. training: bench.py's step, kernel path against the plain path
    train = entry.cylinder_train_setup(device)
    tgraph = train.graph
    _, plain_state, plain_step, train_launches = training_phase("training", train, [kernel], 7)
    train_launches = train_launches[kernel.__name__]

    # 8. timing: one B=128 forward and one train step, kernel path vs plain path
    fwd = timed(lambda: sim.forward(graph, is_training=False), ["gn_nk_fwd"], device=True)
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    log(f"forward B={b}: kernel path {fwd['ms']:.4f} ms (device {fwd['device_ms']:.4f}), plain "
        f"path {fwd_plain_ms:.4f} ms{parent_note(fwd)} ({card})")
    st = step_timing(train, plain_state, plain_step, 8, libs=("gn_nk_fwd", "gn_nk_bwd"))
    tb = tgraph.x.shape[1]
    log(f"train step B={tb}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * tb / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms), plain path "
        f"{st['train_step_plain_ms']:.4f} ms ({1000 * tb / st['train_step_plain_ms']:.1f} "
        f"graph-steps/s){parent_step_note(st)} ({card})")
    log("timing " + json.dumps({"card": card, **{f"forward_{k}": v for k, v in fwd.items()},
                                "forward_plain_ms": fwd_plain_ms, **st, "blocks": timing,
                                "backward_blocks": bwd_timing}))

    # 9.-11. the graph transformer's inference path; 12.-14. its train step
    tf_records = transformer_phases(device, card)
    tf_train_records, tf_train_launches = transformer_train_phases(device, card)
    for rec in tf_records:  # the forward kernels also ran in the train steps
        rec["launches"] += tf_train_launches[rec["name"]][0]
    # 15.-18. both models' inference paths on the graded mesh (CSR layout)
    graded_records, graded_ffn_launches, graded_ffn = graded_phases(device, card)
    tf_records[1]["launches"] += graded_ffn_launches
    tf_records[1]["max_abs_err"] = max(tf_records[1]["max_abs_err"],
                                       graded_ffn.pop("max_abs_err"))
    tf_records[1]["graded"] = graded_ffn  # its time and bound at [27,008·16, 64]
    # 19.-21. both models' training steps on the graded mesh (CSR layout)
    graded_train_records, graded_train_launches, graded_ffn_bwd = graded_train_phases(
        device, card)
    # 22.-24. the Transolver++ train step and its gumbel kernel
    gumbel_record = transolver_phases(device, card)
    # 25.-28. the loader, the trainer's fit of cylinder.json's model (and of
    # the transformer), checkpoint and resume, predict
    fit_launches, fit_info = trainer_phases(device, card, st["train_step_ms"])
    log("fit " + json.dumps({"card": card, **fit_info}))
    for rec in tf_records:  # the transformer's forward kernels ran in phase 26b
        rec["launches"] += fit_launches[rec["name"]][0]
    for rec, name in zip(tf_train_records, (ATTN["name"], FFN["name"])):
        rec["launches"] += fit_launches[name][1]
    ffn_name = tf_records[1]["name"]
    for rec in graded_records:  # the CSR forward kernels also ran in the train steps
        rec["launches"] += graded_train_launches[rec["name"]][0]
    tf_records[1]["launches"] += graded_train_launches[ffn_name][0]
    tf_train_records[1]["launches"] += graded_train_launches[ffn_name][1]
    tf_train_records[1]["max_abs_err"] = max(tf_train_records[1]["max_abs_err"],
                                             graded_ffn_bwd.pop("max_abs_err"))
    tf_train_records[1]["graded"] = graded_ffn_bwd  # its time and bound at [27,008·16, 64]

    # 29. the attention kernels' world seam; 30.-31. DeformingPlate's train
    # step, fit and predict with world edges
    world = world_phases(device, card)
    plate_launches, plate_info = plate_phases(device, card)
    log("plate " + json.dumps({"card": card, **plate_info}))
    # 32.-34. the panels workload: the hidden-128 FFN kernels, its train
    # step, fit and predict
    panels_records, panels_launches, head32 = panels_phases(device, card, build_log)
    # 35.-37. rows 1-4 at hidden 64 and 128; epd at MeshGraphNets' width
    wide_records = wide_phases(device, card, build_log)
    # 38. rows 1-4's world seam; 39.-40. DeformingPlate's MeshGraphNet with
    # world edges: its train step, fit and predict
    seam, plate_epd_launches, plate_bound = plate_epd_phases(device, card)
    # 41.-43. world edges found again in rollouts, previous data on the
    # aneurysm configs, the concat world layout
    option_launches = option_phases(device, card)
    # 44.-45. sub-mesh partitions: epd and the transformer on RCB parts
    submesh_launches = submesh_phases(device, card)
    # 46.-48. rows 5-10 at every width JAX fuses; the hidden-32 transformer
    small_records, small_launches = small_width_phases(device, card, build_log)
    # 49.-51. rows 1-4 at every width and activation JAX fuses; epd at hidden 16
    gn_width_records = gn_width_phases(device, card, build_log)
    # 52.-53. rows 1-4 with MLPs of 1 to 8 layers, with and without the
    # RMSNorm tail; epd at MeshGraphNets' width with its 3-layer MLPs
    gn_depth_records = gn_depth_phases(device, card, build_log)
    for rec in (*tf_records, *tf_train_records, *graded_records, *graded_train_records):
        if rec["name"] in world:
            rec["world"] = world[rec["name"]]
            rec["max_abs_err"] = max(rec["max_abs_err"], rec["world"]["max_abs_err"])
        for name, (fwd_n, bwd_n) in (*plate_launches.items(), *panels_launches.items()):
            rec["launches"] += (fwd_n if rec["name"] == name else
                                bwd_n if rec["name"] == f"{name}_backward" else 0)

    fwd_bound = bound(*gn_block_work(x_in, e_in, graph.edge_mask, blocks[1]))
    bwd_bound = bound(*gn_block_work(x_in, e_in, graph.edge_mask, blocks[1], backward=True))
    log(f"card: {card}")
    records = [
        dict(FWD, route="cuda",
             launches=infer_launches + train_launches[0] + fit_launches[kernel.__name__][0],
             max_abs_err=max(errors.values()), ms=timing["middle"]["ms"],
             plain_ms=timing["middle"]["plain_ms"], bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None, device_ms=timing["middle"]["device_ms"],
             variants=timing),
        dict(BWD, route="cuda", launches=train_launches[1] + fit_launches[kernel.__name__][1],
             max_abs_err=max(bwd_errors.values()), ms=bwd_timing["middle"]["ms"],
             plain_ms=bwd_timing["middle"]["plain_ms"], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             device_ms=bwd_timing["middle"]["device_ms"], variants=bwd_timing),
        *tf_records,
        *tf_train_records,
        *graded_records,
        *graded_train_records,
        gumbel_record,
        *panels_records,
        *wide_records,
        *small_records,
        *gn_width_records,
        *gn_depth_records,
    ]
    for rec in records:  # the world seam's check and times; phases 39-42's launches
        if rec["name"] in seam:
            rec["world"] = seam[rec["name"]]
            rec["max_abs_err"] = max(rec["max_abs_err"], rec["world"]["max_abs_err"])
        rec["launches"] += plate_epd_launches.get(rec["name"], 0)
        rec["launches"] += small_launches.get(rec["name"], 0)  # phase 47's hidden-128 FFN
        for name, (fwd_n, bwd_n) in option_launches.items():
            if name == "fused_gn_block_nk":  # row 1 at the plate MeshGraphNet's width
                name = gn_record_name("nk", MGN_HIDDEN, False)
            rec["launches"] += (fwd_n if rec["name"] == name else
                                bwd_n if rec["name"] == f"{name}_backward" else 0)
        for name, (fwd_n, bwd_n) in submesh_launches.items():  # hidden 32 and 64
            rec["launches"] += (fwd_n if rec["name"] == name else
                                bwd_n if rec["name"] == f"{name}_backward" else 0)
        if rec["name"] in head32:  # rows 5/6 at panels' head width 32
            rec["head_width_32"] = head32[rec["name"]]
        if rec["name"] in plate_bound:  # rows 1/2 at the plate MeshGraphNet's shape
            rec["plate"] = plate_bound[rec["name"]]
    missing = set(seam) - {rec["name"] for rec in records}
    if missing:
        raise AssertionError(f"no record in the kernels line for {sorted(missing)}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def transformer_phases(device, card):
    """Phases 9-11 on the graph transformer of scripts/bench_models.py
    (10 blocks, hidden 64, 4 heads, B=64); returns the kernels' records."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    attn, attn_plain = ea_ops.fused_edge_attention_nk, ea_ops.fused_edge_attention_nk_reference
    ffn, ffn_plain = ffn_ops.fused_gated_ffn, ffn_ops.gated_ffn_reference
    gn = nk_ops.fused_gn_block_nk
    setup = entry.transformer_setup(device, num_steps=ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1)
    sim, graph, nk = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    blocks = model.processor_list
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    heads = blocks[0].attention.num_heads
    dh = hidden // heads
    n_blocks = len(blocks)
    valid_slots = int(graph.edge_mask.sum())
    log(f"transformer slice: {n} nodes x {b} samples, hidden {hidden}, {heads} heads of {dh}, "
        f"K={nk.k_slots}, {nk.total_rows} slots ({valid_slots} edges), {n_blocks} blocks")

    # 9. kernel checks at the slice's shape, same inputs for kernel and plain version
    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    args = (q, k, v, graph.senders, graph.receivers, graph.edge_mask, nk)
    blk0 = blocks[0]
    x = randn(n, b, hidden, scale=1.0)
    ffn_args = (x, blk0.gated_mlp, blk0.norm2)
    with torch.inference_mode():
        out = attn(*args)
        torch.cuda.synchronize()
        ref = attn_plain(*args)
        log("attention kernel check")
        attn_err = compare("out", out, ref, ATTN_RTOL, atol=ATTN_ATOL)
        g_, k_, nb_ = nk.num_groups, nk.k_slots, nk.node_block
        mask = graph.edge_mask.clone().view(g_, k_, nb_)
        mask[:, :, :EMPTY_RECEIVERS] = False
        mask = mask.reshape(-1).contiguous()
        rows_e = (graph.senders, graph.receivers, mask)
        out_e = attn(q, k, v, *rows_e, nk)
        torch.cuda.synchronize()
        ref_e = attn_plain(q, k, v, *rows_e, nk)
        attn_err = max(attn_err, compare(f"out, {EMPTY_RECEIVERS} receivers a node block "
                                         "without a valid slot", out_e, ref_e, ATTN_RTOL,
                                         atol=ATTN_ATOL))
        empty = out_e.view(g_, nb_, -1)[:, :EMPTY_RECEIVERS]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("attention: a receiver without valid slots is not exactly 0")
        log(f"  {g_ * EMPTY_RECEIVERS} receivers without a valid slot: exact zeros")
        # the statistics the forward keeps under autograd, against their
        # plain version
        check_kept_stats("attention", ea_ops.KERNELS, (q, k, v), rows_e, nk, out_e)
        del out_e, ref_e

        y = ffn(*ffn_args)
        torch.cuda.synchronize()
        y_ref = ffn_plain(*ffn_args)
        log("gated FFN kernel check (block 0's weights)")
        ffn_err = compare("y", y, y_ref, FFN_TOL)

        # 11. (kernel part) times of the kernels, their plain versions and
        # the library's masked attention on the same inputs: dense, with
        # the mesh's adjacency as its boolean mask (rows: receivers); the
        # attention through the op module's name, which --parent's turns
        # point at the parent's wrapper
        attn_t = dict(timed(lambda: ea_ops.fused_edge_attention_nk(*args), ATTN_NK_LIBS,
                            device=True), plain_ms=cuda_ms(lambda: attn_plain(*args)))
        adj = torch.zeros((n, n), dtype=torch.bool, device=device)
        ev = graph.edge_mask
        adj[graph.receivers[ev].long(), graph.senders[ev].long()] = True
        qd, kd, vd = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=adj)

        lib_out = library().permute(2, 0, 1, 3)
        rows = graph.node_mask
        lib_err = (lib_out[rows].float() - ref[rows].float()).abs().max().item()
        attn_t["library_ms"] = cuda_ms(library)
        ffn_t = dict(timed(lambda: ffn(*ffn_args), ["ffn"], device=True),
                     plain_ms=cuda_ms(lambda: ffn_plain(*ffn_args)))
    log(f"  attention time: kernel {attn_t['ms']:.4f} ms (device {attn_t['device_ms']:.4f})"
        f"{parent_note(attn_t)}, plain {attn_t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask {attn_t['library_ms']:.4f} ms "
        f"(max abs difference to the plain version {lib_err:.6g}) ({card})")
    log(f"  gated FFN time: kernel {ffn_t['ms']:.4f} ms (device {ffn_t['device_ms']:.4f}), "
        f"plain {ffn_t['plain_ms']:.4f} ms{parent_note(ffn_t)} ({card})")
    del lib_out, qd, kd, vd, adj

    # 10. slice: the B=64 forward and the rollout, kernel path, counts from 0
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain path
    attn.launches = ffn.launches = gn.launches = gn.backward_launches = 0
    out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    fwd_launches = (attn.launches, ffn.launches)
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    launches = (attn.launches, ffn.launches)
    log(f"transformer forward: (attention, FFN) kernel launches {fwd_launches} ({n_blocks} "
        f"blocks); with the {ROLLOUT_STEPS}-step rollout: {launches}")
    if fwd_launches != (n_blocks, n_blocks):
        raise AssertionError(f"expected {n_blocks} launches of each kernel per forward, "
                             f"got {fwd_launches}")
    want = n_blocks * (1 + ROLLOUT_STEPS)
    if launches != (want, want) or gn.launches or gn.backward_launches:
        raise AssertionError(f"expected {want} launches of each transformer kernel and none "
                             f"of the GraphNetBlock's, got {launches}, {gn.launches}, "
                             f"{gn.backward_launches}")

    out_plain = plain_sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("transformer forward vs plain path (valid nodes)")
    rows = graph.node_mask
    compare("net_out", out.net_out, out_plain.net_out, TF_SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, TF_SLICE_TOL, rows=rows)
    check_rollouts("transformer", res, make_batched_rollout_fn(plain_sim)(frames))

    # 11. timing: the B=64 forward and one middle block, kernel path vs plain path
    fwd = timed(lambda: sim.forward(graph, is_training=False), ("ffn", *ATTN_NK_LIBS),
                device=True)
    fwd_ms = fwd["ms"]
    fwd_plain_ms = cuda_ms(lambda: plain_sim.forward(graph, is_training=False))
    mid = blocks[n_blocks // 2]
    block_args = (randn(n, b, hidden, scale=1.0), graph.senders, graph.receivers,
                  graph.edge_mask, graph.node_mask, graph.pos)
    with torch.inference_mode():
        block_ms = cuda_ms(lambda: mid(*block_args, tiling=nk))
        block_plain_ms = cuda_ms(lambda: mid(*block_args))
    log(f"transformer forward B={b}: kernel path {fwd_ms:.4f} ms (device "
        f"{fwd['device_ms']:.4f}; {1000 * b / fwd_ms:.1f} graph-steps/s){parent_note(fwd)}, "
        f"plain path {fwd_plain_ms:.4f} ms ({1000 * b / fwd_plain_ms:.1f}); middle block "
        f"{block_ms:.4f} ms, plain {block_plain_ms:.4f} ms ({card})")
    log("transformer timing " + json.dumps({
        "card": card, **{f"forward_{k}": v for k, v in fwd.items()},
        "forward_plain_ms": fwd_plain_ms,
        "block_ms": block_ms, "block_plain_ms": block_plain_ms, "attention": attn_t,
        "ffn": ffn_t}))

    # bounds from this run's inputs: bf16 q, k, v read and out written, the
    # slot arrays read, q·k and p·v on the valid slots; x read and y written,
    # the fp32 weights read, 3 products of 64 x 192 per row
    attn_bound = bound(2 * 4 * q.numel() + 5 * nk.total_rows,
                       valid_slots * b * heads * 4 * dh)
    ffn_params = sum(p.numel() for p in (*blk0.gated_mlp.parameters(), blk0.norm2.scale))
    ffn_bound = bound(2 * 2 * x.numel() + 4 * ffn_params,
                      2 * n * b * sum(p.numel() for p in (blk0.gated_mlp.gated.linear1.weight,
                                                         blk0.gated_mlp.gated.linear2.weight,
                                                         blk0.gated_mlp.out.weight)))
    log(f"  bounds: attention {attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN "
        f"{ffn_bound[0]:.6g} ms ({ffn_bound[1]})")
    return [
        dict(ATTN, route="cuda", launches=launches[0], max_abs_err=attn_err,
             bound_ms=attn_bound[0], bound_by=attn_bound[1], **attn_t),
        dict(FFN, route="cuda", launches=launches[1], max_abs_err=ffn_err, ms=ffn_t["ms"],
             plain_ms=ffn_t["plain_ms"], bound_ms=ffn_bound[0], bound_by=ffn_bound[1],
             library_ms=None, device_ms=ffn_t["device_ms"],
             **{k: v for k, v in ffn_t.items() if k.startswith("parent")}),
    ]


def transformer_train_phases(device, card):
    """Phases 12-14 on the graph transformer's train step
    (scripts/bench_models.py:62-99 for ``transformer_nk``, :142-166: 10
    blocks, hidden 64, 4 heads, B=64); returns the backward kernels'
    records and {wrapper name: (forward, backward) launches} of phase 13."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.models.layers import ACTIVATIONS
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.utils import gradcheck

    attn, ffn = ea_ops.fused_edge_attention_nk, ffn_ops.fused_gated_ffn
    train = entry.transformer_train_setup(device)
    sim, graph, nk = train.simulator, train.graph, train.tiling
    blocks = sim.model.processor_list
    n, b = graph.x.shape[:2]
    hidden = sim.model.hidden_size
    heads = blocks[0].attention.num_heads
    dh = hidden // heads
    valid_slots = int(graph.edge_mask.sum())
    senders, receivers, mask = graph.senders, graph.receivers, graph.edge_mask
    gen = torch.Generator(device=device).manual_seed(3)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    # 12. backward kernel checks at the slice's shape: each kernel against
    # its plain backward and both against fp32 autograd (utils/gradcheck.py)
    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    cot = randn(n, b, heads, dh, scale=1.0)

    def attention(fn, m=mask):
        return lambda *qkv: (fn(*qkv, senders, receivers, m, nk), [])

    def attention_grads(m):
        """(kernel, plain backward, fp32) gradients and the kernel's and plain
        backward's retained graphs, with ``m`` as the slot mask."""
        before = attn.backward_launches
        gk, kept_k = gradcheck.grads_of(attention(attn, m), (q, k, v), [cot])
        torch.cuda.synchronize()
        if attn.backward_launches != before + 1:
            raise AssertionError("attention: the backward kernel did not launch once")
        gp, kept_p = gradcheck.grads_of(attention(ea_ops.reference_with_backward, m), (q, k, v),
                                        [cot])
        gf, _ = gradcheck.grads_of(attention(ea_ops.fused_edge_attention_nk_reference, m),
                                   (q.float(), k.float(), v.float()), [cot])
        return gk, gp, gf, kept_k, kept_p

    names = ("dq", "dk", "dv")
    gk, gp, gf, kept_k, kept_p = attention_grads(mask)
    rows, ok = gradcheck.compare_grads(names, gk, gp, gf, names)
    log("attention backward kernel check (against the plain backward; both against fp32)")
    log_grad_rows(rows)
    ga, _ = gradcheck.grads_of(attention(ea_ops.fused_edge_attention_nk_reference), (q, k, v),
                               [cot])
    rows_a, ok_a = gradcheck.compare_grads(names[1:], gk[1:], ga[1:], gf[1:], names)
    log("  dk, dv against plain bf16 autograd of the forward's plain version")
    log_grad_rows(rows_a)
    attn_bwd_err = max(r.get("max_abs_err", float("inf")) for r in rows)
    # 14. (kernel part) the backward kernels (through the op module's name,
    # which --parent's turns point at the parent's wrapper), by pass too,
    # its plain backward, and the library's masked attention forward +
    # backward on the same q, k, v
    backward = attention_backward(ea_ops, (q, k, v), (senders, receivers, mask), nk, cot)
    attn_t = dict(timed(backward, ATTN_NK_LIBS, device=True),
                  plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept_p, retain_graph=True)),
                  passes=pass_split(backward))
    splits = {"kernel": attn_t["passes"]}
    if PARENT is not None:
        with parent_kernels(*ATTN_NK_LIBS):
            splits["parent tree"] = attn_t["parent_passes"] = pass_split(backward)
    for tree, split in splits.items():
        log(f"  attention backward device ms by pass, {tree}: " + ", ".join(
            f"{p} {ms:.4f}" for p, ms in sorted(split.items(), key=lambda kv: -kv[1])))
    del kept_k, kept_p, gk, gp, gf, ga, backward
    g_, nb_ = nk.num_groups, nk.node_block
    mask_e = mask.clone().view(g_, nk.k_slots, nb_)
    mask_e[:, :, :EMPTY_RECEIVERS] = False
    mask_e = mask_e.reshape(-1).contiguous()
    ge, gpe, gfe, _, _ = attention_grads(mask_e)
    rows_e, ok_e = gradcheck.compare_grads(names, ge, gpe, gfe, names)
    log(f"  {EMPTY_RECEIVERS} receivers a node block without a valid slot")
    log_grad_rows(rows_e)
    empty = ge[0].view(g_, nb_, -1)[:, :EMPTY_RECEIVERS]
    if not torch.equal(empty, torch.zeros_like(empty)):
        raise AssertionError("attention backward: dq of a receiver without valid slots is not 0")
    log(f"  dq of the {g_ * EMPTY_RECEIVERS} receivers without a valid slot: exact zeros")
    if not (ok and ok_a and ok_e):
        raise AssertionError("attention backward kernel out of bounds")
    del ge, gpe, gfe
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd_bwd = timed(lambda: torch.autograd.grad(ea_ops.fused_edge_attention_nk(
        *leaves, senders, receivers, mask, nk), leaves, cot), ATTN_NK_LIBS, device=True)
    attn_t.update({f"fwd_bwd_{k}": v for k, v in fwd_bwd.items()})
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    adj[graph.receivers[mask].long(), senders[mask].long()] = True
    dense = [t.permute(1, 2, 0, 3).contiguous().requires_grad_(True) for t in (q, k, v)]
    cot_d = cot.permute(1, 2, 0, 3).contiguous()
    attn_t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*dense, attn_mask=adj), dense, cot_d))
    del adj, dense, cot_d, leaves
    log(f"  attention backward time: kernel {attn_t['ms']:.4f} ms (device "
        f"{attn_t['device_ms']:.4f}){parent_note(attn_t)}, plain backward "
        f"{attn_t['plain_ms']:.4f} ms; forward + backward: kernels {attn_t['fwd_bwd_ms']:.4f} ms "
        f"(device {attn_t['fwd_bwd_device_ms']:.4f}){parent_note(fwd_bwd)}, "
        f"scaled_dot_product_attention with the adjacency mask {attn_t['library_ms']:.4f} ms "
        f"({card})")

    blk0 = blocks[0]
    x = randn(n, b, hidden, scale=1.0)
    cot_x = randn(n, b, hidden, scale=1.0)
    ffn_names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]
    silu_mlp = copy.deepcopy(blk0.gated_mlp)
    silu_mlp.gated.use_silu, silu_mlp.gated.act_fn = True, ACTIVATIONS["silu"]

    def feed_forward(fn, mlp, norm2):
        return lambda xx: (fn(xx, mlp, norm2), ffn_ops._params(mlp, norm2))

    ffn_errs = []
    for act, mlp in (("gelu", blk0.gated_mlp), ("silu", silu_mlp)):
        norm2 = blk0.norm2
        before = ffn.backward_launches
        f_rows, f_ok, kept = gradcheck.check_backward(
            ffn_names, ("dx",), feed_forward(ffn, mlp, norm2),
            feed_forward(ffn_ops.reference_with_backward, mlp, norm2),
            feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(mlp),
                         gradcheck.rounded_copy(norm2)), [x], [cot_x])
        torch.cuda.synchronize()
        log(f"gated FFN backward kernel check ({act}, block 0's weights; against the plain "
            f"backward, both against fp32)")
        log_grad_rows(f_rows)
        if ffn.backward_launches != before + 1:
            raise AssertionError("gated FFN: the backward kernel did not launch once")
        if not f_ok:
            raise AssertionError(f"gated FFN backward kernel ({act}) out of bounds")
        ffn_errs.append(max(r.get("max_abs_err", float("inf")) for r in f_rows))
        if act == "gelu":  # 14. (kernel part)
            ffn_t = ffn_backward_times(kept)
        del kept
    log(f"  gated FFN backward time: kernel {ffn_t['ms']:.4f} ms (device time "
        f"{ffn_t['device_ms']:.4f} ms), plain backward {ffn_t['plain_ms']:.4f} ms ({card})")

    # 13. training: 20 steps of the train step, kernel path against the plain path
    gn = nk_ops.fused_gn_block_nk
    gn.launches = gn.backward_launches = 0
    _, plain_state, plain_step, launches = training_phase("transformer training", train,
                                                          [attn, ffn], 9)
    if gn.launches or gn.backward_launches:
        raise AssertionError("transformer training launched the GraphNetBlock kernels")

    # 14. timing: one middle block forward + backward and the train step,
    # kernel path vs plain path
    mid = blocks[len(blocks) // 2]
    xb = randn(n, b, hidden, scale=1.0).requires_grad_(True)
    cot_b = randn(n, b, hidden, scale=1.0)
    wrt = [xb, *mid.parameters()]

    def block_fwd_bwd(tiling):
        y = mid(xb, senders, graph.receivers, mask, graph.node_mask, graph.pos, tiling=tiling)
        return torch.autograd.grad(y, wrt, cot_b)

    block_ms = cuda_ms(lambda: block_fwd_bwd(nk))
    block_plain_ms = cuda_ms(lambda: block_fwd_bwd(None))
    st = step_timing(train, plain_state, plain_step, 10, libs=("ffn", *ATTN_NK_LIBS))
    log(f"transformer train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, {st['train_step_syncs']} device-to-host "
        f"syncs a step), plain path {st['train_step_plain_ms']:.4f} ms "
        f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s){parent_step_note(st)}; "
        f"middle block forward + backward {block_ms:.4f} ms, plain {block_plain_ms:.4f} ms "
        f"({card})")
    log("transformer train timing " + json.dumps({
        "card": card, **st, "block_fwd_bwd_ms": block_ms,
        "block_fwd_bwd_plain_ms": block_plain_ms, "attention_backward": attn_t,
        "ffn_backward": ffn_t}))

    # bounds from this run's inputs: q, k, v, g_out read and dq, dk, dv
    # written (bf16), the slot arrays read, 5 products of dh per valid slot,
    # sample and head; x, g read and dx written, the fp32 weights read and
    # their gradients written, 8 products of 64 x 192 per row
    attn_bound = bound(2 * 7 * q.numel() + 5 * nk.total_rows, valid_slots * b * heads * 10 * dh)
    ffn_params = ffn_ops._params(blk0.gated_mlp, blk0.norm2)
    ffn_bound = bound(2 * 3 * x.numel() + 8 * sum(p.numel() for p in ffn_params),
                      2 * 8 * n * b * blk0.gated_mlp.gated.linear1.weight.numel())
    log(f"  bounds: attention backward {attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN "
        f"backward {ffn_bound[0]:.6g} ms ({ffn_bound[1]})")
    records = [
        dict(ATTN_BWD, route="cuda", launches=launches[attn.__name__][1], max_abs_err=attn_bwd_err,
             bound_ms=attn_bound[0], bound_by=attn_bound[1], **attn_t),
        dict(FFN_BWD, route="cuda", launches=launches[ffn.__name__][1], max_abs_err=max(ffn_errs),
             ms=ffn_t["ms"], plain_ms=ffn_t["plain_ms"], bound_ms=ffn_bound[0],
             bound_by=ffn_bound[1], library_ms=None, device_ms=ffn_t["device_ms"]),
    ]
    return records, launches


def rollout_pair(label, sim, plain_sim, setup):
    """R windows x T steps of rollout on the kernel path and the plain path,
    held to each other by :func:`check_rollouts`."""
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    check_rollouts(label, make_batched_rollout_fn(sim)(frames),
                   make_batched_rollout_fn(plain_sim)(frames))


def graded_phases(device, card):
    """Phases 15-18: the inference paths of ``epd`` (cylinder widths) and
    the graph transformer (10 blocks, hidden 64, 4 heads) on the graded
    mesh at B=16 (scripts/bench_airfoil.py's batch), in the CSR layout.
    Returns the two CSR kernels' records, and the FFN kernel's launches on
    the graded transformer path and its error against its plain version
    at the graded shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.core import mesh as mesh_lib
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import tiling as tiling_lib
    from graph_physics_tpu_torch.ops.edge_attention import edge_attention
    from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
    from graph_physics_tpu_torch.ops.fused_edge_attention_nk import fused_edge_attention_nk
    from graph_physics_tpu_torch.ops.fused_ffn import fused_gated_ffn, gated_ffn_reference
    from graph_physics_tpu_torch.ops.fused_gnblock_csr import (
        fused_gn_block_csr,
        fused_gn_block_csr_reference,
    )
    from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager

    gn, gn_plain, attn, ffn = (fused_gn_block_csr, fused_gn_block_csr_reference,
                               fused_edge_attention_csr, fused_gated_ffn)
    steps = ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1

    # 15. layout: the graded mesh's statistics, then the manager's choices
    traj = synthetic.make_graded_trajectory(num_steps=2)
    n_valid = traj["mesh_pos"].shape[1]
    ei = mesh_lib.faces_to_edges(traj["cells"][0], n_valid)
    deg = np.bincount(ei[1], minlength=n_valid)
    log(f"graded mesh: {n_valid} nodes, {ei.shape[1]} directed edges, in-degree {deg.min()} to "
        f"{deg.max()} (mean {deg.mean():.4g}, 99th percentile {np.percentile(deg, 99):.4g})")
    cylinder = entry.frame_graph(synthetic.make_trajectory(48, 40, num_steps=2), 0)
    graded = entry.frame_graph(traj, 0)
    for family in ("epd", "transformer"):
        for name, g, want in (("graded", graded, tiling_lib.CSRLayout),
                              ("cylinder", cylinder, tiling_lib.NKTiling)):
            got = FusedTopologyManager(family).layout_for(g)
            log(f"layout [{family}] {name}: {type(got).__name__} ({got.total_rows} rows for "
                f"{int(g.edge_mask.sum())} edges)")
            if not isinstance(got, want):
                raise AssertionError(f"layout [{family}]: {name} took {type(got).__name__}, "
                                     f"expected {want.__name__}")
    del traj, cylinder, graded

    setup = entry.graded_setup(device, num_steps=steps)
    tsetup = entry.graded_transformer_setup(device, num_steps=steps)
    sim, graph, csr = setup.simulator, setup.graph, setup.tiling
    model = sim.model
    n, b = graph.x.shape[:2]
    hidden = model.hidden_size
    valid = int(graph.edge_mask.sum())
    log(f"graded epd slice: {n} nodes x {b} samples, hidden {hidden}, {csr.total_rows} CSR rows "
        f"({valid} edges), {len(model.processor_list)} blocks")

    # 16. CSR kernel checks: each variant against its plain version, same inputs
    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x_in = randn(n, b, hidden)
    e_in = randn(csr.total_rows, b, hidden)
    raw_in = randn(csr.total_rows, b, entry.EDGE_INPUT)
    blocks = model.processor_list
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    errors, timing = {}, {}
    with torch.inference_mode():
        for name, (blk, e, enc, last) in variants.items():
            args = (x_in, e, graph.senders, graph.receivers, graph.edge_mask, blk.edge_block,
                    blk.node_block, csr)
            kw = dict(encoder_params=enc, last_block=last)
            xk, ek = gn(*args, **kw)
            torch.cuda.synchronize()
            xp, ep = gn_plain(*args, **kw, compute_dtype=torch.bfloat16)
            log(f"CSR GraphNetBlock kernel check [{name}]")
            err = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:  # padding rows included: both keep e_in there
                err = max(err, compare("e_out", ek, ep, KERNEL_TOL))
            errors[name] = err
            t = timed(lambda: csr_ops.fused_gn_block_csr(*args, **kw), ["gn_csr_fwd"],
                      device=True)
            timing[name] = dict(t, plain_ms=cuda_ms(lambda: gn_plain(
                *args, **kw, compute_dtype=torch.bfloat16)))
            parent = (f"; parent tree {t['parent_ms']:.4f} ms (device "
                      f"{t['parent_device_ms']:.4f})" if "parent_ms" in t else "")
            log(f"  time: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
                f"{timing[name]['plain_ms']:.4f} ms{parent} ({card})")
        del xk, ek, xp, ep

        tsim, tgraph, tcsr = tsetup.simulator, tsetup.graph, tsetup.tiling
        tblocks = tsim.model.processor_list
        heads = tblocks[0].attention.num_heads
        dh = tsim.model.hidden_size // heads
        q, k, v = (randn(n, b, heads, dh) for _ in range(3))
        ta = (tgraph.senders, tgraph.receivers)
        out = attn(q, k, v, *ta, tgraph.edge_mask, tcsr)
        torch.cuda.synchronize()
        ref = edge_attention(q, k, v, *ta, tgraph.edge_mask)
        log("CSR attention kernel check")
        attn_err = compare("out", out, ref, ATTN_RTOL, atol=ATTN_ATOL)
        gone = torch.arange(0, n, EMPTY_STRIDE, device=device)
        mask_e = tgraph.edge_mask & ~torch.isin(tgraph.receivers, gone)
        out_e = attn(q, k, v, *ta, mask_e, tcsr)
        torch.cuda.synchronize()
        ref_e = edge_attention(q, k, v, *ta, mask_e)
        attn_err = max(attn_err, compare(f"out, every {EMPTY_STRIDE}th receiver without a valid "
                                         "row", out_e, ref_e, ATTN_RTOL, atol=ATTN_ATOL))
        empty = torch.cat([out_e[gone], out_e[~tgraph.node_mask]])
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("CSR attention: a receiver without valid rows is not exactly 0")
        log(f"  {len(gone)} receivers with their rows masked out and "
            f"{int((~tgraph.node_mask).sum())} padding nodes: exact zeros")
        # the statistics the forward keeps under autograd, against their
        # plain version
        check_kept_stats("CSR attention", ea_ops.KERNELS, (q, k, v), (*ta, mask_e), tcsr, out_e)
        # the shared body computes what the parent's CSR kernel did
        same_bits_as_parent("CSR attention output", lambda: ea_ops.fused_edge_attention_csr(
            q, k, v, *ta, mask_e, tcsr), ATTN_CSR_LIBS)
        del out_e, ref_e, mask_e

        tx = randn(n, b, tsim.model.hidden_size, scale=1.0)
        ffn_args = (tx, tblocks[0].gated_mlp, tblocks[0].norm2)
        y = ffn(*ffn_args)
        torch.cuda.synchronize()
        y_ref = gated_ffn_reference(*ffn_args)
        log("gated FFN kernel check at the graded shape (block 0's weights)")
        ffn_err = compare("y", y, y_ref, FFN_TOL)
        del y, y_ref

    # 17. graded slices: the B=16 forwards and the rollouts, counts from 0
    plain_sim = copy.deepcopy(sim)
    plain_sim.model.tiling = None  # every block on the plain edge-list path
    others = (fused_gn_block_nk, fused_edge_attention_nk)
    for kern in (gn, attn, ffn, *others):
        kern.launches = 0
    with torch.no_grad():
        out = sim.forward(graph, is_training=False)
    torch.cuda.synchronize()
    fwd_launches = gn.launches
    log(f"graded epd forward: {fwd_launches} CSR GraphNetBlock launches ({len(blocks)} blocks)")
    if fwd_launches != len(blocks):
        raise AssertionError(f"expected {len(blocks)} CSR GraphNetBlock launches per forward, "
                             f"got {fwd_launches}")
    with torch.no_grad():
        out_plain = plain_sim.forward(graph, is_training=False)
    rows = graph.node_mask
    if tuple(out.outputs.shape) != (n, b, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log("graded epd forward vs plain path (valid nodes)")
    compare("net_out", out.net_out, out_plain.net_out, SLICE_TOL, rows=rows)
    compare("outputs", out.outputs, out_plain.outputs, SLICE_TOL, rows=rows)
    rollout_pair("graded epd", sim, plain_sim, setup)  # the plain rollout launches none
    gn_launches = gn.launches
    if gn_launches != len(blocks) * (1 + ROLLOUT_STEPS):
        raise AssertionError(f"expected {len(blocks) * ROLLOUT_STEPS} CSR GraphNetBlock launches "
                             f"in the rollout, got {gn_launches - fwd_launches}")

    t_plain = copy.deepcopy(tsim)
    t_plain.model.tiling = None
    attn.launches = ffn.launches = 0
    with torch.no_grad():
        tout = tsim.forward(tgraph, is_training=False)
    torch.cuda.synchronize()
    t_fwd = (attn.launches, ffn.launches)
    log(f"graded transformer forward: (CSR attention, FFN) launches {t_fwd} "
        f"({len(tblocks)} blocks)")
    if t_fwd != (len(tblocks), len(tblocks)):
        raise AssertionError(f"expected {len(tblocks)} launches of each kernel, got {t_fwd}")
    with torch.no_grad():
        tout_plain = t_plain.forward(tgraph, is_training=False)
    log("graded transformer forward vs plain path (valid nodes)")
    compare("net_out", tout.net_out, tout_plain.net_out, TF_SLICE_TOL, rows=rows)
    compare("outputs", tout.outputs, tout_plain.outputs, TF_SLICE_TOL, rows=rows)
    rollout_pair("graded transformer", tsim, t_plain, tsetup)
    want = len(tblocks) * (1 + ROLLOUT_STEPS)
    t_launches = (attn.launches, ffn.launches)
    if t_launches != (want, want) or any(k.launches for k in others) or \
            gn.launches != gn_launches:
        raise AssertionError(f"expected {want} launches of each graded transformer kernel and "
                             f"no other, got {t_launches}")

    # 18. timing: the kernels, their plain versions, the library's masked
    # attention, a middle block and the forward of each model, both paths
    with torch.inference_mode():
        attn_args = (q, k, v, *ta, tgraph.edge_mask)
        # through the op module's name, which --parent's turns point at the
        # parent's wrapper
        attn_t = dict(timed(lambda: ea_ops.fused_edge_attention_csr(*attn_args, tcsr),
                            ATTN_CSR_LIBS, device=True),
                      plain_ms=cuda_ms(lambda: edge_attention(*attn_args)), library_ms=None)
        ffn_t = dict(timed(lambda: ffn(*ffn_args), ["ffn"], device=True),
                     plain_ms=cuda_ms(lambda: gated_ffn_reference(*ffn_args)))
        adj = qd = None
        try:  # dense [N, N] adjacency as the mask: 0.73 GB as bool
            adj = torch.zeros((n, n), dtype=torch.bool, device=device)
            ev = tgraph.edge_mask
            adj[tgraph.receivers[ev].long(), tgraph.senders[ev].long()] = True
            qd, kd, vd = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
            attn_t["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=adj), reps=5)
            lib_note = f"{attn_t['library_ms']:.4f} ms"
        except RuntimeError as exc:  # out of memory, or no kernel for the mask
            lib_note = f"does not run on the card ({str(exc).splitlines()[0]})"
        del adj, qd
        torch.cuda.empty_cache()
        mid, tmid = blocks[len(blocks) // 2], tblocks[len(tblocks) // 2]
        gblk = (x_in, e_in, graph.senders, graph.receivers, graph.edge_mask)
        tblk = (tx, tgraph.senders, tgraph.receivers, tgraph.edge_mask, tgraph.node_mask,
                tgraph.pos)
        blocks_t = {"epd_block_ms": cuda_ms(lambda: mid(*gblk, tiling=csr)),
                    "epd_block_plain_ms": cuda_ms(lambda: mid(*gblk)),
                    "transformer_block_ms": cuda_ms(lambda: tmid(*tblk, tiling=tcsr)),
                    "transformer_block_plain_ms": cuda_ms(lambda: tmid(*tblk))}
        epd_fwd = timed(lambda: sim.forward(graph, is_training=False), ["gn_csr_fwd"],
                        device=True)
        tf_fwd = timed(lambda: tsim.forward(tgraph, is_training=False), ATTN_CSR_LIBS,
                       device=True)
        fwd = {**{f"epd_forward_{k}": v for k, v in epd_fwd.items()},
               "epd_forward_plain_ms": cuda_ms(lambda: plain_sim.forward(graph,
                                                                          is_training=False)),
               **{f"transformer_forward_{k}": v for k, v in tf_fwd.items()},
               "transformer_forward_plain_ms": cuda_ms(
                   lambda: t_plain.forward(tgraph, is_training=False))}
    log(f"  CSR attention time: kernel {attn_t['ms']:.4f} ms (device {attn_t['device_ms']:.4f})"
        f"{parent_note(attn_t)}, plain {attn_t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention with the adjacency mask: {lib_note} ({card})")
    log(f"  gated FFN time at the graded shape: kernel {ffn_t['ms']:.4f} ms (device "
        f"{ffn_t['device_ms']:.4f}), plain {ffn_t['plain_ms']:.4f} ms{parent_note(ffn_t)} "
        f"({card})")
    log(f"graded forward B={b}: epd kernel path {fwd['epd_forward_ms']:.4f} ms (device "
        f"{fwd['epd_forward_device_ms']:.4f}; {1000 * b / fwd['epd_forward_ms']:.1f} "
        f"graph-steps/s){parent_note(epd_fwd)}, plain {fwd['epd_forward_plain_ms']:.4f} ms; "
        f"transformer kernel path {fwd['transformer_forward_ms']:.4f} ms (device "
        f"{fwd['transformer_forward_device_ms']:.4f}; "
        f"{1000 * b / fwd['transformer_forward_ms']:.1f} graph-steps/s){parent_note(tf_fwd)}, "
        f"plain {fwd['transformer_forward_plain_ms']:.4f} ms; middle blocks: "
        f"epd {blocks_t['epd_block_ms']:.4f} / {blocks_t['epd_block_plain_ms']:.4f} ms, "
        f"transformer {blocks_t['transformer_block_ms']:.4f} / "
        f"{blocks_t['transformer_block_plain_ms']:.4f} ms ({card})")
    log("graded timing " + json.dumps({"card": card, **fwd, **blocks_t, "gn_blocks": timing,
                                       "attention": attn_t, "ffn": ffn_t, "library": lib_note}))

    # bounds from this run's inputs: the CSR block as gn_block_work with the
    # row pointers read and the first layer's receiver and sender parts done
    # per node; the attention's q, k, v read and out written (bf16), the row
    # arrays read, q·k and p·v on the valid rows
    nbytes, flops = gn_block_work(x_in, e_in, graph.edge_mask, blocks[1])
    first = 2 * hidden * hidden  # the x_recv and x_send parts of the first layer
    flops -= 2 * b * first * (valid - n)
    gn_bound = bound(nbytes + 4 * (n + 1), flops)
    attn_bound = bound(2 * 4 * q.numel() + 5 * tcsr.total_rows + 4 * (n + 1),
                       valid * b * heads * 4 * dh)
    # the gated FFN as phase 11's bound: x read and y written (bf16), the fp32
    # weights read, 3 products of 64 x 192 a row
    mlp0 = tblocks[0].gated_mlp
    ffn_params = ffn_ops._params(mlp0, tblocks[0].norm2)
    ffn_t["bound_ms"], ffn_t["bound_by"] = bound(
        2 * 2 * tx.numel() + 4 * sum(p.numel() for p in ffn_params),
        2 * n * b * sum(w.numel() for w in (mlp0.gated.linear1.weight,
                                             mlp0.gated.linear2.weight, mlp0.out.weight)))
    log(f"  bounds: CSR GraphNetBlock {gn_bound[0]:.6g} ms ({gn_bound[1]}), CSR attention "
        f"{attn_bound[0]:.6g} ms ({attn_bound[1]}), gated FFN at the graded shape "
        f"{ffn_t['bound_ms']:.6g} ms ({ffn_t['bound_by']})")
    records = [
        dict(GN_CSR, route="cuda", launches=gn_launches, max_abs_err=max(errors.values()),
             ms=timing["middle"]["ms"], plain_ms=timing["middle"]["plain_ms"],
             bound_ms=gn_bound[0], bound_by=gn_bound[1], library_ms=None,
             device_ms=timing["middle"]["device_ms"], variants=timing),
        dict(ATTN_CSR, route="cuda", launches=t_launches[0], max_abs_err=attn_err,
             bound_ms=attn_bound[0], bound_by=attn_bound[1], **attn_t),
    ]
    return records, t_launches[1], dict(ffn_t, max_abs_err=ffn_err)


def graded_train_phases(device, card):
    """Phases 19-21: the training steps of ``epd`` (cylinder widths) and
    the graph transformer (10 blocks, hidden 64, 4 heads) on the graded
    mesh at B=16, in the CSR layout. Returns the two CSR backward
    kernels' records, {wrapper name: (forward, backward) launches} of the
    phase-20 runs, and the gated-FFN backward's numbers at the graded
    shape: its error against its plain backward, its time, its plain
    backward's and its bound."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as gn_ops
    from graph_physics_tpu_torch.ops.edge_attention import edge_attention
    from graph_physics_tpu_torch.utils import gradcheck

    gn, attn, ffn = (gn_ops.fused_gn_block_csr, ea_ops.fused_edge_attention_csr,
                     ffn_ops.fused_gated_ffn)
    train = entry.graded_train_setup(device)
    ttrain = entry.graded_transformer_train_setup(device)
    sim, graph, csr = train.simulator, train.graph, train.tiling
    tsim, tgraph, tcsr = ttrain.simulator, ttrain.graph, ttrain.tiling
    model, blocks, tblocks = sim.model, sim.model.processor_list, tsim.model.processor_list
    n, b = graph.x.shape[:2]
    hidden, thidden = model.hidden_size, tsim.model.hidden_size
    heads = tblocks[0].attention.num_heads
    dh = thidden // heads
    valid = int(graph.edge_mask.sum())
    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    # 19. backward kernel checks at the graded shapes: each CSR GraphNetBlock
    # variant, the CSR attention and the gated FFN against their plain
    # backwards, all against fp32 autograd (utils/gradcheck.py)
    x_in, e_in = randn(n, b, hidden), randn(csr.total_rows, b, hidden)
    raw_in = randn(csr.total_rows, b, entry.EDGE_INPUT)
    variants = {
        "folded": (blocks[0], raw_in, model.edges_encoder, False),
        "middle": (blocks[1], e_in, None, False),
        "last": (blocks[-1], e_in, None, True),
    }
    rows3 = (graph.senders, graph.receivers, graph.edge_mask)
    gn_errors, gn_t, failed = {}, {}, []
    for name, (blk, e, enc, last) in variants.items():
        cot_x, cot_e = randn(n, b, hidden, scale=1.0), randn(csr.total_rows, b, hidden, scale=1.0)
        before = gn.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x_in, e, rows3, (enc, blk.edge_block, blk.node_block), csr, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"CSR GraphNetBlock backward kernel check [{name}] "
            f"({gn.backward_launches - before} launch)")
        log_grad_rows(grad_rows)
        if gn.backward_launches != before + 1:
            raise AssertionError(f"CSR backward [{name}]: the backward kernel did not launch")
        if not ok:
            failed.append(name)
        gn_errors[name] = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
        gn_t[name] = backward_times(
            f"CSR backward [{name}]",
            lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True),
            lambda: torch.autograd.grad(*kept["plain"], retain_graph=True), ["gn_csr_bwd"], card)
        del kept
    if failed:
        raise AssertionError(f"CSR GraphNetBlock backward kernel out of bounds for {failed}")

    q, k, v = (randn(n, b, heads, dh) for _ in range(3))
    cot = randn(n, b, heads, dh, scale=1.0)
    ta = (tgraph.senders, tgraph.receivers)
    gone = torch.arange(0, n, EMPTY_STRIDE, device=device)
    names = ("dq", "dk", "dv")
    attn_err, attn_t = 0.0, {}
    for label, m in (("", tgraph.edge_mask),
                     (f", every {EMPTY_STRIDE}th receiver without a valid row",
                      tgraph.edge_mask & ~torch.isin(tgraph.receivers, gone))):
        def attention(fn, m=m):
            return lambda *qkv: (fn(*qkv, *ta, m, tcsr), [])

        before = attn.backward_launches
        # the plain backward is plain autograd of edge_attention
        a_rows, ok, kept = gradcheck.check_backward(
            names, names, attention(attn), attention(ea_ops.reference_with_backward),
            lambda *qkv, m=m: (edge_attention(*qkv, *ta, m), []), (q, k, v), [cot])
        torch.cuda.synchronize()
        log(f"CSR attention backward kernel check{label} (against autograd of edge_attention; "
            "both against fp32)")
        log_grad_rows(a_rows)
        if attn.backward_launches != before + 1:
            raise AssertionError("CSR attention: the backward kernel did not launch once")
        if not ok:
            raise AssertionError(f"CSR attention backward kernel out of bounds{label}")
        attn_err = max([attn_err] + [r.get("max_abs_err", float("inf")) for r in a_rows])
        if not label:  # 21. (kernel part)
            backward = attention_backward(ea_ops, (q, k, v), (*ta, m), tcsr, cot)
            same_bits_as_parent("CSR attention dq, dk, dv", backward, ATTN_CSR_LIBS)
            attn_t = dict(timed(backward, ATTN_CSR_LIBS, device=True),
                          plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept["plain"],
                                                                       retain_graph=True)),
                          passes=pass_split(backward))
            log("  CSR attention backward device ms by pass: " + ", ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(attn_t["passes"].items(),
                                                    key=lambda kv: -kv[1])))
        else:
            dq = torch.autograd.grad(*kept["kernel"], retain_graph=True)[0]
            empty = torch.cat([dq[gone], dq[~tgraph.node_mask]])
            if not torch.equal(empty, torch.zeros_like(empty)):
                raise AssertionError("CSR attention backward: dq of a receiver without valid "
                                     "rows is not exactly 0")
            log(f"  dq of the {len(gone)} receivers with their rows masked out and of the "
                f"{int((~tgraph.node_mask).sum())} padding nodes: exact zeros")
        del kept

    blk0 = tblocks[0]
    tx, cot_t = randn(n, b, thidden, scale=1.0), randn(n, b, thidden, scale=1.0)
    ffn_names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]

    def feed_forward(fn, mlp, norm2):
        return lambda xx: (fn(xx, mlp, norm2), ffn_ops._params(mlp, norm2))

    before = ffn.backward_launches
    f_rows, f_ok, kept = gradcheck.check_backward(
        ffn_names, ("dx",), feed_forward(ffn, blk0.gated_mlp, blk0.norm2),
        feed_forward(ffn_ops.reference_with_backward, blk0.gated_mlp, blk0.norm2),
        feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(blk0.gated_mlp),
                     gradcheck.rounded_copy(blk0.norm2)), [tx], [cot_t])
    torch.cuda.synchronize()
    log("gated FFN backward kernel check at the graded shape (block 0's weights; against the "
        "plain backward, both against fp32)")
    log_grad_rows(f_rows)
    if ffn.backward_launches != before + 1:
        raise AssertionError("gated FFN: the backward kernel did not launch once")
    if not f_ok:
        raise AssertionError("gated FFN backward kernel out of bounds at the graded shape")
    ffn_t = ffn_backward_times(kept)
    del kept
    # its bound as phase 14's: x, g read and dx written (bf16), the fp32
    # weights read and their gradients written, 8 products of 64 x 192 a row
    ffn_params = ffn_ops._params(blk0.gated_mlp, blk0.norm2)
    ffn_t["bound_ms"], ffn_t["bound_by"] = bound(
        2 * 3 * tx.numel() + 8 * sum(p.numel() for p in ffn_params),
        2 * 8 * n * b * blk0.gated_mlp.gated.linear1.weight.numel())
    ffn_t["max_abs_err"] = max(r.get("max_abs_err", float("inf")) for r in f_rows)
    log(f"  gated FFN backward time at the graded shape: kernel {ffn_t['ms']:.4f} ms (device "
        f"time {ffn_t['device_ms']:.4f} ms), plain backward {ffn_t['plain_ms']:.4f} ms, bound "
        f"{ffn_t['bound_ms']:.6g} ms ({ffn_t['bound_by']}) ({card})")

    # 20. graded training: 20 steps of each family, kernel path against the
    # plain path, counts from 0 just before each
    _, plain_state, plain_step, launches = training_phase("graded epd training", train, [gn], 12)
    _, t_plain_state, t_plain_step, t_launches = training_phase(
        "graded transformer training", ttrain, [attn, ffn], 13)
    launches.update(t_launches)

    # 21. timing: a middle block forward + backward of each family and the
    # train steps on both paths; the library's masked attention forward +
    # backward over the dense adjacency, where it fits
    mid, tmid = blocks[len(blocks) // 2], tblocks[len(tblocks) // 2]
    xb = randn(n, b, hidden).requires_grad_(True)
    eb = randn(csr.total_rows, b, hidden).requires_grad_(True)
    txb = randn(n, b, thidden, scale=1.0).requires_grad_(True)
    cots = (randn(n, b, hidden, scale=1.0), randn(csr.total_rows, b, hidden, scale=1.0))
    cot_tb = randn(n, b, thidden, scale=1.0)
    wrt, twrt = [xb, eb, *mid.parameters()], [txb, *tmid.parameters()]

    def epd_block(tiling):
        return torch.autograd.grad(mid(xb, eb, *rows3, tiling=tiling), wrt, cots)

    def tf_block(tiling):
        y = tmid(txb, *ta, tgraph.edge_mask, tgraph.node_mask, tgraph.pos, tiling=tiling)
        return torch.autograd.grad(y, twrt, cot_tb)

    blocks_t = {"epd_block_fwd_bwd_ms": cuda_ms(lambda: epd_block(csr)),
                "epd_block_fwd_bwd_plain_ms": cuda_ms(lambda: epd_block(None)),
                "transformer_block_fwd_bwd_ms": cuda_ms(lambda: tf_block(tcsr)),
                "transformer_block_fwd_bwd_plain_ms": cuda_ms(lambda: tf_block(None))}
    steps = {"epd": step_timing(train, plain_state, plain_step, 14,
                                libs=("gn_csr_fwd", "gn_csr_bwd")),
             "transformer": step_timing(ttrain, t_plain_state, t_plain_step, 15,
                                        libs=ATTN_CSR_LIBS)}
    for fam, st in steps.items():
        log(f"graded {fam} train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
            f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
            f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
            f"{st['train_step_host_enqueue_ms']:.4f} ms, {st['train_step_syncs']} "
            f"device-to-host syncs a step), plain path {st['train_step_plain_ms']:.4f} ms "
            f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s){parent_step_note(st)} "
            f"({card})")
    log(f"  middle blocks forward + backward: epd {blocks_t['epd_block_fwd_bwd_ms']:.4f} / "
        f"{blocks_t['epd_block_fwd_bwd_plain_ms']:.4f} ms, transformer "
        f"{blocks_t['transformer_block_fwd_bwd_ms']:.4f} / "
        f"{blocks_t['transformer_block_fwd_bwd_plain_ms']:.4f} ms (kernel / plain) ({card})")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd_bwd = timed(lambda: torch.autograd.grad(ea_ops.fused_edge_attention_csr(
        *leaves, *ta, tgraph.edge_mask, tcsr), leaves, cot), ATTN_CSR_LIBS, device=True)
    attn_t.update({f"fwd_bwd_{k}": v for k, v in fwd_bwd.items()})
    attn_t["library_ms"] = None
    adj = dense = cot_d = None
    try:  # dense [N, N] adjacency as the mask: 0.73 GB as bool
        adj = torch.zeros((n, n), dtype=torch.bool, device=device)
        ev = tgraph.edge_mask
        adj[tgraph.receivers[ev].long(), tgraph.senders[ev].long()] = True
        dense = [t.permute(1, 2, 0, 3).contiguous().requires_grad_(True) for t in (q, k, v)]
        cot_d = cot.permute(1, 2, 0, 3).contiguous()
        attn_t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*dense, attn_mask=adj), dense, cot_d), reps=5)
        lib_note = f"{attn_t['library_ms']:.4f} ms"
    except RuntimeError as exc:  # out of memory, or no kernel for the mask
        lib_note = f"does not run on the card ({str(exc).splitlines()[0]})"
        attn_t["library_note"] = lib_note
    del adj, dense, cot_d, leaves
    torch.cuda.empty_cache()
    log(f"  CSR attention backward: kernel {attn_t['ms']:.4f} ms (device "
        f"{attn_t['device_ms']:.4f}){parent_note(attn_t)}, plain backward "
        f"{attn_t['plain_ms']:.4f} ms; forward + backward: kernels {attn_t['fwd_bwd_ms']:.4f} ms "
        f"(device {attn_t['fwd_bwd_device_ms']:.4f})"
        f"{parent_note({k[8:]: v for k, v in attn_t.items() if k.startswith('fwd_bwd_')})}, "
        f"scaled_dot_product_attention with the adjacency mask: {lib_note} ({card})")
    log("graded train timing " + json.dumps({
        "card": card, **{f"{fam}_{k}": v for fam, st in steps.items() for k, v in st.items()},
        **blocks_t, "gn_backward": gn_t, "attention_backward": attn_t,
        "ffn_backward": ffn_t}))

    # bounds from this run's inputs: the CSR block's backward as
    # gn_block_work's, with the forward's aggregate, the row pointers and
    # the transpose read and the first layer's receiver and sender parts
    # done per node; the attention
    # backward's q, k, v, g_out read and dq, dk, dv written (bf16), the row
    # arrays and the transpose read, 5 products of dh per valid row, sample
    # and head (the kernels' reads of the forward's output and statistics
    # are the design's, not the function's)
    nbytes, flops = gn_block_work(x_in, e_in, graph.edge_mask, blocks[1], backward=True)
    flops -= 3 * 2 * b * 2 * hidden * hidden * (valid - n)
    gn_bound = bound(nbytes + 2 * x_in.numel() + 4 * (n + 1) * 2 + 4 * valid, flops)
    attn_bound = bound(2 * 7 * q.numel() + 9 * tcsr.total_rows + 8 * (n + 1) + 4 * valid,
                       valid * b * heads * 10 * dh)
    log(f"  bounds: CSR GraphNetBlock backward {gn_bound[0]:.6g} ms ({gn_bound[1]}), CSR "
        f"attention backward {attn_bound[0]:.6g} ms ({attn_bound[1]})")
    records = [
        dict(GN_CSR_BWD, route="cuda", launches=launches[gn.__name__][1],
             max_abs_err=max(gn_errors.values()), ms=gn_t["middle"]["ms"],
             plain_ms=gn_t["middle"]["plain_ms"], bound_ms=gn_bound[0], bound_by=gn_bound[1],
             library_ms=None, device_ms=gn_t["middle"]["device_ms"], variants=gn_t),
        dict(ATTN_CSR_BWD, route="cuda", launches=launches[attn.__name__][1],
             max_abs_err=attn_err, bound_ms=attn_bound[0], bound_by=attn_bound[1], **attn_t),
    ]
    return records, launches, ffn_t



def transolver_phases(device, card):
    """Phases 22-24: the gumbel kernel at the Transolver slice's logits
    [16·2,432, 4, 32] and at the graded mesh's [16·27,136, 4, 32], the
    B=16 Transolver++ eval forward and train step
    (``entry.transolver_train_setup``: 4 blocks, hidden 64, 4 heads, 32
    slices) on the kernel path against the plain path on the same bits,
    and their times. Returns the kernel's record."""
    import math

    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import gumbel as gumbel_ops

    kernel = gumbel_ops.gumbel_perturb
    train = entry.transolver_train_setup(device)
    gtrain = entry.transolver_train_setup(device, graded=True)
    sim, graph = train.simulator, train.graph
    blocks = sim.model.model.blocks
    heads, slices = blocks[0].Attn.heads, blocks[0].Attn.slice_num
    b, n = graph.x.shape[:2]
    gn = gtrain.graph.x.shape[1]
    log(f"Transolver slice: B={b} x {n} nodes (graded: {gn} points), hidden "
        f"{sim.model.model.placeholder.numel()}, {heads} heads, {slices} slices, "
        f"{len(blocks)} blocks, stacked [B, N, F]")
    gen = torch.Generator(device=device).manual_seed(22)
    shapes = {"slice": (b * n, heads, slices), "graded": (b * gn, heads, slices)}

    # 22. the kernel against its plain version on the same key: the same
    # bits, outputs within GUMBEL_ATOL; the noise's distribution; other
    # keys; the passthrough gradient
    errors = {}
    for label, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        key = gumbel_ops.draw_key(gen, device)
        count = x.numel()
        out = kernel(x, key)
        torch.cuda.synchronize()
        same_bits = torch.equal(gumbel_ops.philox_bits(count, key),
                                gumbel_ops.random_bits(count, key))
        log(f"gumbel kernel check [{label}] {list(shape)} bf16 ({count} draws): the kernel's "
            f"Philox words equal the plain version's: {same_bits}")
        if not same_bits:
            raise AssertionError(f"gumbel [{label}]: the kernel's random bits differ")
        errors[label] = compare("out", out, gumbel_ops.gumbel_perturb_reference(x, key), 0.0,
                                atol=GUMBEL_ATOL)
        xg = x.clone().requires_grad_(True)
        cot = torch.randn(shape, generator=gen, device=device)
        (grad,) = torch.autograd.grad(kernel(xg, key), xg, cot)
        if not torch.equal(grad, cot.to(torch.bfloat16)):
            raise AssertionError(f"gumbel [{label}]: the gradient is not the exact passthrough")
        log("  gradient: the exact passthrough cot.to(bf16)")
        if label != "slice":
            continue
        g = kernel(torch.zeros_like(x), key).flatten().double()
        other = kernel(torch.zeros_like(x), gumbel_ops.draw_key(gen, device)).flatten().double()
        mean, std = g.mean().item(), g.std().item()
        srt = torch.sort(g).values
        cdf = torch.exp(-torch.exp(-srt))
        i = torch.arange(1, count + 1, device=device, dtype=torch.float64)
        ks = max((i / count - cdf).max().item(), (cdf - (i - 1) / count).max().item())
        corr = torch.corrcoef(torch.stack([g, other]))[0, 1].item()
        ks_limit, corr_limit = KS_COEFF / math.sqrt(count), 5.0 / math.sqrt(count)
        moment_limit = GUMBEL_MOMENT_SES * GUMBEL_SE_COEFF / math.sqrt(count)
        gamma, sigma = 0.5772156649, math.pi / math.sqrt(6.0)
        log(f"  noise over {count} draws: mean {mean:.6f} (γ {gamma:.6f}), std {std:.6f} "
            f"(π/√6 {sigma:.6f}; limit ±{moment_limit:.4g} each), KS against the Gumbel CDF "
            f"{ks:.6g} (limit {ks_limit:.6g}), correlation with another key's draw "
            f"{corr:.3g} (limit {corr_limit:.3g})")
        if abs(mean - gamma) > moment_limit or abs(std - sigma) > moment_limit:
            raise AssertionError("gumbel: the noise's mean or std is off Gumbel(0, 1)'s")
        if ks > ks_limit or abs(corr) > corr_limit or torch.equal(g, other):
            raise AssertionError("gumbel: the noise is not Gumbel(0, 1) or two keys agree")
        del g, other, srt, cdf, i
    del x, xg, out, grad, cot
    torch.cuda.empty_cache()

    # 23. the B=16 eval forward on both paths (no noise, no launch), then 20
    # train steps on the kernel path, 4 launches a step, against the plain
    # path on the same bits
    base = entry.transolver_setup(device)
    plain_eval = plain_copy(base.simulator)
    reset_counts([kernel])
    with torch.inference_mode():
        out = base.simulator.forward(base.graph, is_training=False)
        ref = plain_eval.forward(base.graph, is_training=False)
    torch.cuda.synchronize()
    if tuple(out.outputs.shape) != (b, n, entry.OUTPUT) or out.outputs.dtype != torch.float32:
        raise AssertionError(f"unexpected output {tuple(out.outputs.shape)} {out.outputs.dtype}")
    log(f"Transolver eval forward B={b}: {kernel.launches} gumbel launches (eval draws no "
        "noise); kernel path vs plain path (valid nodes)")
    if kernel.launches:
        raise AssertionError("the Transolver eval forward launched the gumbel kernel")
    compare("outputs", out.outputs, ref.outputs, TF_SLICE_TOL, rows=base.graph.node_mask)
    fwd_ms = cuda_ms(lambda: base.simulator.forward(base.graph, is_training=False))
    del base, plain_eval, out, ref
    _, plain_state, plain_step, launches = training_phase(
        "Transolver training", train, [kernel], 23, per_step_want=(len(blocks), 0))

    # 24. times: the kernel, its plain version and the torch.rand draw at
    # both shapes; the train steps with the kernel, with the torch.rand
    # draw and on the plain path, at both sizes
    draw_t = {}
    for label, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        key = gumbel_ops.draw_key(gen, device)

        def torch_rand_draw():  # the counterpart of JAX's XLA draw (transolver.py:57-59)
            u = torch.rand(shape, generator=gen, device=device)
            return x.float() + gumbel_ops.gumbel_noise(u)

        bnd = bound(x.numel() * (2 + 4), 0)
        fns = {"": lambda: kernel(x, key),
               "plain_": lambda: gumbel_ops.gumbel_perturb_reference(x, key),
               "torch_rand_": torch_rand_draw}
        t = {"bound_ms": bnd[0], "bound_by": bnd[1]}
        for name, fn in fns.items():
            t[f"{name}ms"] = device_ms(fn)
            t[f"{name}call_ms"] = cuda_ms(fn)
        draw_t[label] = t
        log(f"gumbel [{label}] {list(shape)}, device time (call time by CUDA events): kernel "
            f"{t['ms']:.4f} ({t['call_ms']:.4f}) ms, plain version {t['plain_ms']:.4f} "
            f"({t['plain_call_ms']:.4f}) ms, torch.rand draw {t['torch_rand_ms']:.4f} "
            f"({t['torch_rand_call_ms']:.4f}) ms; bound {t['bound_ms']:.6g} ms ({t['bound_by']}) "
            f"({card})")
        del x
    steps = {}
    for label, setup in (("slice", train), ("graded", gtrain)):
        if label == "slice":
            p_state, p_step = plain_state, plain_step
        else:
            p_state, p_step = entry.make_trainer(plain_copy(setup.simulator))
        st = step_timing(setup, p_state, p_step, 24)
        rand = entry.transolver_train_setup(device, fused_gumbel=False, graded=label == "graded")
        st["train_step_torch_rand_ms"] = cuda_ms(
            lambda: rand.train_step(rand.state, rand.graph, gen), warmup=2, reps=10)
        steps[label] = st
        bb = batch_size(setup.graph)
        log(f"Transolver train step [{label}] B={bb} x {setup.graph.x.shape[1]} nodes: gumbel "
            f"kernel {st['train_step_ms']:.4f} ms ({1000 * bb / st['train_step_ms']:.1f} "
            f"graph-steps/s; the host enqueues a step in {st['train_step_host_enqueue_ms']:.4f} "
            f"ms, {st['train_step_syncs']} device-to-host syncs a step), torch.rand draw "
            f"{st['train_step_torch_rand_ms']:.4f} ms, plain path {st['train_step_plain_ms']:.4f}"
            f" ms ({card})")
        del rand, p_state, p_step
        torch.cuda.empty_cache()
    faster = "kernel" if draw_t["slice"]["ms"] < draw_t["slice"]["torch_rand_ms"] else "torch.rand"
    log(f"  the faster draw at the slice's shape: {faster}; eval forward B={b} {fwd_ms:.4f} ms")
    log("transolver timing " + json.dumps({"card": card, "forward_ms": fwd_ms, "draw": draw_t,
                                           "steps": steps}))
    t = draw_t["slice"]
    return dict(GUMBEL, route="cuda", launches=launches[kernel.__name__][0],
                max_abs_err=max(errors.values()), ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["torch_rand_ms"])


# ---- phases 29-31: DeformingPlate and the attention kernels' world seam -------

#: phase 29: the world seam at the graded mesh's CSR shape, a synthetic
#: sidecar of this many slots a sample (scripts/bench_plate.py's budget)
WORLD_SLOTS = 1024
#: phase 31: plate trajectories of the fit (2 of PLATE_FIT_FRAMES frames:
#: one B=64 batch each) and epochs
PLATE_FIT_TRAJECTORIES, PLATE_FIT_FRAMES, PLATE_FIT_EPOCHS = 2, 65, 2


def synthetic_sidecar(n_valid, n, batch, width, targets, gen, device):
    """A [W, B] sidecar on ``n_valid`` nodes: half its slots end at
    ``targets`` (receivers without a valid mesh row), the rest at random
    nodes, senders random; every fifth slot masked, the last 8 the padding
    convention's (sender 0, receiver n - 1, masked)."""
    import torch

    def ints(hi):
        return torch.randint(0, hi, (width, batch), generator=gen, device=device)

    recv = torch.where(torch.rand((width, batch), generator=gen, device=device) < 0.5,
                       targets[ints(len(targets))], ints(n_valid))
    send = ints(n_valid)
    mask = (torch.arange(width, device=device) % 5 != 4)[:, None].expand(width, batch).clone()
    send[-8:], recv[-8:], mask[-8:] = 0, n - 1, False
    return send.int().contiguous(), recv.int().contiguous(), mask.contiguous()


def world_kernel_check(label, ops, qkv, rows, layout, sidecar, cot, card, libs, plain_libs,
                       timing=True):
    """Phase 29 for one layout: the forward kernel with the world pieces of
    ``sidecar`` against its plain version (joint_edge_attention) on the
    same bf16 inputs, the joint statistics it keeps, exact zeros where a
    receiver has neither a valid row nor a world edge, the same bits on two
    calls; the backward's dq, dk, dv, dnum_w, dden_w against the plain
    backward and fp32 autograd (utils/gradcheck.py), dnum_w and dden_w 0
    where a receiver has neither; without world pieces, the parent tree's
    bits (with --parent); times with and without world, their bounds, and
    the library's masked attention over mesh and world edges where its
    per-sample mask fits (with ``timing``). Returns (max abs error forward,
    backward, times or None)."""
    import torch
    import torch.nn.functional as F
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
    from graph_physics_tpu_torch.ops.edge_attention import world_attention_parts
    from graph_physics_tpu_torch.utils import gradcheck

    name = ops.__name__.rsplit(".", 1)[-1]
    op = getattr(ops, name)
    kernels = ops.KERNELS
    senders, receivers, mask = rows
    q, k, v = qkv
    n, b, h, dh = q.shape
    with torch.no_grad():
        parts = world_attention_parts(q, k, v, *sidecar)
    ws, wr, wm = sidecar
    hit = torch.zeros((n, b), dtype=torch.bool, device=q.device)
    hit[wr[wm].long(), torch.nonzero(wm)[:, 1]] = True
    has_rows = torch.zeros(n, dtype=torch.bool, device=q.device)
    has_rows[receivers[mask].long()] = True
    world_only, neither = hit & ~has_rows[:, None], ~hit & ~has_rows[:, None]
    log(f"world seam [{label}]: {n} nodes x {b} samples, {int(wm.sum())} world edges over "
        f"{ws.shape[0]} slots a sample ({int(wm.sum(0).max())} at most), "
        f"{int(world_only.sum())} (node, sample) receivers with world edges and no mesh row, "
        f"{int(neither.sum())} with neither")
    if not world_only.any():
        raise AssertionError(f"world seam [{label}]: no receiver has world edges without a "
                             "mesh row")
    before = op.launches
    with torch.inference_mode():
        out = op(*qkv, *rows, layout, world_parts=parts)
        torch.cuda.synchronize()
        if op.launches != before + 1:
            raise AssertionError(f"world seam [{label}]: the forward kernel did not launch")
        ref = csr_ops.joint_edge_attention(*qkv, *rows, parts)
        err = compare("out (joint mesh + world softmax)", out, ref, ATTN_RTOL, atol=ATTN_ATOL)
        if not torch.equal(out[neither], torch.zeros_like(out[neither])):
            raise AssertionError(f"world seam [{label}]: a receiver with neither mesh rows nor "
                                 "world edges is not exactly 0")
        calls = [kernels[0](*qkv, *rows, layout, keep_stats=True, world=parts) for _ in range(2)]
        (kept, (m_k, inv_k, out32)), again = calls
        if not all(torch.equal(a, c) for a, c in zip((kept, m_k, inv_k, out32),
                                                      (again[0], *again[1]))):
            raise AssertionError(f"world seam [{label}]: two calls give other bits")
        if not (torch.equal(kept, out) and torch.equal(out32.to(torch.bfloat16), out)):
            raise AssertionError(f"world seam [{label}]: the kept fp32 output is not the output")
        m_p, inv_p = csr_ops.softmax_stats(q, k, *rows, world=parts)
        some = inv_p > 0
        compare("kept joint max", m_k, m_p, STATS_MAX_TOL)
        compare("kept joint 1/denominator", inv_k, inv_p, STATS_INV_RTOL, rows=some, atol=0.0)
        if (inv_k[~some] != 0).any():
            raise AssertionError(f"world seam [{label}]: 1/denominator not 0 without a softmax")
        log(f"  {int(neither.sum())} receivers with neither: exact zeros; two calls: the same "
            "output, statistics and fp32 output")
    names = ("dq", "dk", "dv", "dnum_w", "dden_w")
    s_w = parts[2]

    def attention(fn):
        return lambda q_, k_, v_, nw, dw: (fn(q_, k_, v_, *rows, layout,
                                              world_parts=(nw, dw, s_w)), [])

    def plain(*a, world_parts):
        return csr_ops.joint_edge_attention(*a[:6], world_parts)

    before = op.backward_launches
    grad_rows, ok, kept = gradcheck.check_backward(
        names, names, attention(op),
        attention(lambda *a, world_parts: csr_ops.reference_with_backward(
            *a, world_parts=world_parts)),
        attention(plain), [*qkv, *parts[:2]], [cot])
    torch.cuda.synchronize()
    log(f"  world seam backward [{label}] ({op.backward_launches - before} launch; against the "
        "plain backward, both against fp32)")
    log_grad_rows(grad_rows)
    if op.backward_launches != before + 1 or not ok:
        raise AssertionError(f"world seam [{label}]: backward kernel out of bounds or not "
                             "launched")
    bwd_err = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
    grads = [torch.autograd.grad(*kept["kernel"], retain_graph=True) for _ in range(2)]
    if not all(torch.equal(a, c) for a, c in zip(*grads)):
        raise AssertionError(f"world seam [{label}]: two backwards give other bits")
    dnum_w, dden_w = grads[0][3:]
    if not (torch.equal(dnum_w[neither], torch.zeros_like(dnum_w[neither]))
            and torch.equal(dden_w[neither], torch.zeros_like(dden_w[neither]))):
        raise AssertionError(f"world seam [{label}]: dnum_w, dden_w not 0 where a receiver "
                             "has neither")
    log("  two backwards: the same bits; dnum_w, dden_w exactly 0 where a receiver has neither")
    # the mesh-only kernels: the parent tree's bits, forward and backward
    same_bits_as_parent(f"{label} without world, forward", lambda: getattr(ops, name)(
        *qkv, *rows, layout), libs)
    same_bits_as_parent(f"{label} without world, dq dk dv", attention_backward(
        ops, qkv, rows, layout, cot), libs)

    if not timing:
        del kept
        return err, bwd_err, None

    # times: with world (forward; backward; plain), without world, bounds
    def this_tree(fn):  # the world calls: the parent's kernels have no world seam
        return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}

    t = {}
    with torch.inference_mode():
        t["world"] = dict(this_tree(lambda: op(*qkv, *rows, layout, world_parts=parts)),
                          plain_ms=cuda_ms(lambda: csr_ops.joint_edge_attention(*qkv, *rows,
                                                                                parts)))
        t["mesh"] = dict(timed(lambda: getattr(ops, name)(*qkv, *rows, layout), libs,
                               device=True))
        t["parts_ms"] = cuda_ms(lambda: world_attention_parts(q, k, v, *sidecar))
    leaves = [x.detach().clone().requires_grad_(True) for x in (*qkv, *parts[:2])]
    graph_w = (op(*leaves[:3], *rows, layout, world_parts=(*leaves[3:], s_w)), leaves)
    t["world_backward"] = dict(this_tree(lambda: torch.autograd.grad(
        graph_w[0], graph_w[1], cot, retain_graph=True)),
        plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept["plain"], retain_graph=True)),
        passes=pass_split(lambda: torch.autograd.grad(graph_w[0], graph_w[1], cot,
                                                      retain_graph=True)))
    t["mesh_backward"] = dict(timed(attention_backward(ops, qkv, rows, layout, cot), libs,
                                    device=True))
    valid = int(mask.sum())
    world_edges = int(wm.sum())
    nbh = n * b * h
    ops_fwd = (valid * b + world_edges) * h * 4 * dh  # the world's exp-sums are the pieces'
    t["world"]["bound"] = bound(2 * 4 * q.numel() + 5 * senders.numel()
                                + 4 * q.numel() + 2 * 4 * nbh, ops_fwd + 2 * nbh * dh)
    t["mesh"]["bound"] = bound(2 * 4 * q.numel() + 5 * senders.numel(), valid * b * h * 4 * dh)
    t["world_backward"]["bound"] = bound(2 * 7 * q.numel() + 5 * senders.numel() + 4 * nbh
                                         + 4 * q.numel() + 4 * nbh, valid * b * h * 10 * dh)
    t["mesh_backward"]["bound"] = bound(2 * 7 * q.numel() + 5 * senders.numel(),
                                        valid * b * h * 10 * dh)
    # the library: one masked SDPA over each sample's mesh and world edges
    t["world"]["library_ms"] = None
    if b * n * n <= 2 ** 31:
        adj = torch.zeros((b, 1, n, n), dtype=torch.bool, device=q.device)
        adj[:, 0, receivers[mask].long(), senders[mask].long()] = True
        adj[torch.nonzero(wm)[:, 1], 0, wr[wm].long(), ws[wm].long()] = True
        qd, kd, vd = (x.permute(1, 2, 0, 3).contiguous() for x in qkv)
        with torch.inference_mode():
            t["world"]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=adj))
        del adj, qd, kd, vd
    for key in ("world", "mesh", "world_backward", "mesh_backward"):
        tt = t[key]
        tt["bound_ms"], tt["bound_by"] = tt.pop("bound")
        log(f"  {key.replace('_', ' ')} time: kernel {tt['ms']:.4f} ms (device "
            f"{tt['device_ms']:.4f}){parent_note(tt)}"
            + (f", plain {tt['plain_ms']:.4f} ms" if "plain_ms" in tt else "")
            + (f", scaled_dot_product_attention over mesh + world {tt['library_ms']:.4f} ms"
               if tt.get("library_ms") is not None else "")
            + f"; bound {tt['bound_ms']:.6g} ms ({tt['bound_by']}) ({card})")
    log(f"  world_attention_parts (the pieces, torch ops): {t['parts_ms']:.4f} ms; world "
        f"backward device ms by pass: " + ", ".join(
            f"{p} {ms:.4f}" for p, ms in t["world_backward"]["passes"].items()))
    del kept, graph_w, leaves
    return err, bwd_err, t


def world_phases(device, card):
    """Phase 29: the world seam of rows 5/6 (NK) at plate's shape, with the
    plate batch's own sidecars (entry.plate_setup: 44x30 sheet, B=64,
    1,024 slots), and of rows 7/8 (CSR) on the graded mesh with a
    synthetic [1,024, 16] sidecar; returns {record name: world fields}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as nk_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling

    gen = torch.Generator(device=device).manual_seed(29)

    def randn(shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    out = {}
    setup = entry.plate_setup(device, accumulate_stats=False, mp_steps=1)
    g, layout = setup.graph, setup.tiling
    if not isinstance(layout, NKTiling):
        raise AssertionError(f"phase 29: the plate batch took {type(layout).__name__}, "
                             "not the NK layout")
    n, b = g.x.shape[:2]
    qkv = [randn((n, b, 4, 16)) for _ in range(3)]
    cot = randn((n, b, 4, 16), scale=1.0)
    rows = (g.senders, g.receivers, g.edge_mask)
    sidecar = (g.wedge_senders, g.wedge_receivers, g.wedge_mask)
    err, bwd_err, t = world_kernel_check("NK, plate", nk_ops, qkv, rows, layout, sidecar, cot,
                                         card, ATTN_NK_LIBS, ATTN_NK_LIBS)
    out[ATTN["name"]] = dict(t["world"], mesh_ms=t["mesh"]["ms"],
                             mesh_device_ms=t["mesh"]["device_ms"], parts_ms=t["parts_ms"],
                             max_abs_err=err)
    out[ATTN_BWD["name"]] = dict(t["world_backward"], mesh_ms=t["mesh_backward"]["ms"],
                                 mesh_device_ms=t["mesh_backward"]["device_ms"],
                                 max_abs_err=bwd_err)
    del setup, g, qkv, cot
    torch.cuda.empty_cache()

    setup = entry.graded_transformer_setup(device, mp_steps=1, accumulate_stats=False)
    g, layout = setup.graph, setup.tiling
    n, b = g.x.shape[:2]
    n_valid = int(g.node_mask.sum())
    gone = torch.arange(0, n_valid, EMPTY_STRIDE, device=device)
    mask = (g.edge_mask & ~torch.isin(g.receivers, gone)).contiguous()
    qkv = [randn((n, b, 4, 16)) for _ in range(3)]
    cot = randn((n, b, 4, 16), scale=1.0)
    sidecar = synthetic_sidecar(n_valid, n, b, WORLD_SLOTS, gone[::2], gen, device)
    err, bwd_err, t = world_kernel_check("CSR, graded", csr_ops, qkv,
                                         (g.senders, g.receivers, mask), layout, sidecar, cot,
                                         card, ATTN_CSR_LIBS, ATTN_CSR_LIBS)
    out[ATTN_CSR["name"]] = dict(t["world"], mesh_ms=t["mesh"]["ms"],
                                 mesh_device_ms=t["mesh"]["device_ms"], parts_ms=t["parts_ms"],
                                 max_abs_err=err)
    out[ATTN_CSR_BWD["name"]] = dict(t["world_backward"], mesh_ms=t["mesh_backward"]["ms"],
                                     mesh_device_ms=t["mesh_backward"]["device_ms"],
                                     max_abs_err=bwd_err)
    del setup, g, qkv, cot
    torch.cuda.empty_cache()
    return out


def plate_param():
    from graph_physics_tpu_torch.training import config as config_lib

    return config_lib.load_params(str(ROOT / "training_config" / "plate.json"))


def plate_fit_run(device, card, run_name="fit_plate"):
    """Phase 31's run: plate.json's transformer (lecun weights from seed 0)
    through Trainer.fit (the CLI's stack: PLATE_FIT_TRAJECTORIES
    trajectories, B=TF_FIT_BATCH, PLATE_FIT_EPOCHS epochs, a
    VAL_STEPS-step validation rollout) and predict from its checkpoint.
    Raises if fit's records or launches are wrong; returns {"tr",
    "val_ds", "steps", "fit_s", "fit_launches", "predict_launches",
    "predict_rmse", "validate_rmse", "rel", "n_blocks", "attn", "ffn"},
    for phase 31 to hold predict to validate (and for
    scripts/rollout_repeat.py)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as nk_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.loss import l2_loss
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig

    ffn = ffn_ops.fused_gated_ffn
    param = plate_param()
    frame_cfg = entry.plate_frame_config()
    ds = memory_dataset_class()
    trajs = [synthetic.make_plate_trajectory(44 + i, 30, PLATE_FIT_FRAMES)
             for i in range(PLATE_FIT_TRAJECTORIES)]
    train_ds = ds(trajs, synthetic.plate_meta_dict(PLATE_FIT_FRAMES), frame_cfg)
    val_ds = ds([synthetic.make_plate_trajectory(44, 30, VAL_STEPS + 1)],
                synthetic.plate_meta_dict(VAL_STEPS + 1), frame_cfg)
    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
    lecun_parameters(sim, torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=PLATE_FIT_EPOCHS, batch_size=TF_FIT_BATCH, learning_rate=1e-3,
                        warmup=100, packed=True, fused=True,
                        out_dir=str(ROOT / "build" / "fit"), run_name=run_name, seed=0)
    shutil.rmtree(ROOT / "build" / "fit" / run_name, ignore_errors=True)
    _, world_dev = config_lib.get_world_configs(param)
    steps = PLATE_FIT_EPOCHS * PLATE_FIT_TRAJECTORIES
    tr = Trainer(sim, train_ds, val_ds, l2_loss, cfg,
                 noise_cfg=config_lib.get_noise_config(param), world_pos=world_dev,
                 device=device)
    attn_ops = (nk_ops.fused_edge_attention_nk, csr_ops.fused_edge_attention_csr)
    reset_counts([*attn_ops, ffn])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    attn = attn_ops[0] if isinstance(tr.sim.model.tiling, NKTiling) else attn_ops[1]
    fit_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    records = epoch_records(tr)
    n_blocks = len(tr.sim.model.processor_list)
    log(f"fit, plate.json ({n_blocks} blocks, hidden {tr.sim.model.hidden_size}, bf16, "
        f"{type(tr.sim.model.tiling).__name__} layout, world edges as each frame's sidecar; "
        f"{PLATE_FIT_TRAJECTORIES} trajectories of {PLATE_FIT_FRAMES} frames, B={TF_FIT_BATCH}, "
        f"{PLATE_FIT_EPOCHS} epochs, {tr.state.step} steps, validation {VAL_STEPS} rollout "
        f"steps): {fit_s:.1f} s ({card})")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    want = (n_blocks * (tr.state.step + PLATE_FIT_EPOCHS * VAL_STEPS), n_blocks * tr.state.step)
    log(f"  launches (forward, backward): " + ", ".join(
        f"{k} {v}" for k, v in fit_launches.items()) + f"; expected {want} each")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(records) != PLATE_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or tr.state.step != steps or any(v != want for v in fit_launches.values())):
        raise AssertionError(f"phase 31: {tr.state.step} steps, launches {fit_launches}, "
                             f"records {records}")
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(ROOT / "training_config" / "plate.json"),
        "--model_path", tr.ckpt_dir, "--bf16", "--fused", "--device", str(device)])
    reset_counts([*attn_ops, ffn])
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, plate: checkpoint step {stack.step}, rollout of {pred.predictions.shape[0]} "
        f"steps, launches (forward, backward): " + ", ".join(
            f"{k} {v}" for k, v in predict_launches.items()) + f", expected {want} each: "
        f"rmse_all_rollout {pred.rmse_all_rollout:.8g}, validate reported {want_rmse:.8g} "
        f"(relative difference {rel:.3g}, limit {PREDICT_RTOL})")
    return {"tr": tr, "val_ds": val_ds, "steps": steps, "fit_s": fit_s,
            "fit_launches": fit_launches, "predict_launches": predict_launches,
            "checkpoint_step": stack.step, "predict_rmse": pred.rmse_all_rollout,
            "validate_rmse": want_rmse, "rel": rel, "n_blocks": n_blocks, "attn": attn,
            "ffn": ffn}


def plate_phases(device, card):
    """Phases 30-31: plate.json's transformer at full width (10 blocks,
    hidden 64, 4 heads) trained at B=64 with world edges through the
    attention kernels' world seam, then through Trainer.fit and predict;
    returns {wrapper name: (forward, backward) launches} of both."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as nk_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling

    # 30. the plate train step: kernel path against the plain path
    train = entry.plate_train_setup(device)
    layout = train.tiling
    attn = (nk_ops.fused_edge_attention_nk if isinstance(layout, NKTiling)
            else csr_ops.fused_edge_attention_csr)
    ffn = ffn_ops.fused_gated_ffn
    g = train.graph
    wm = g.wedge_mask
    log(f"plate train step: FusedTopologyManager chose the {type(layout).__name__} layout "
        f"({layout.num_nodes} nodes, {layout.total_rows} rows); B={g.x.shape[1]}, "
        f"{int(wm.sum())} world edges over {wm.shape[0]} slots a sample "
        f"({int((wm.sum(0) > 0).sum())} samples with any, {int(wm.sum(0).max())} at most)")
    _, plain_state, plain_step, launches = training_phase("plate training", train,
                                                          [attn, ffn], 30)
    st = step_timing(train, plain_state, plain_step, 31)  # the parent has no world seam
    st = {k: v for k, v in st.items() if "parent" not in k}
    b = g.x.shape[1]
    log(f"plate train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, CUDA events "
        f"{st['train_step_enqueue_events_ms']:.4f} ms over the same steps, "
        f"{st['train_step_syncs']} device-to-host syncs a step), plain path "
        f"{st['train_step_plain_ms']:.4f} ms "
        f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s) ({card})")
    del train, plain_state, plain_step
    torch.cuda.empty_cache()

    # 31. plate through Trainer.fit (the CLI's stack) and predict
    run = plate_fit_run(device, card)
    attn, fit_launches, predict_launches = (run["attn"], run["fit_launches"],
                                            run["predict_launches"])
    want = (run["n_blocks"] * VAL_STEPS, 0)
    if (run["checkpoint_step"] != run["steps"] or run["rel"] > PREDICT_RTOL
            or any(v != want for v in predict_launches.values())):
        raise AssertionError(f"phase 31: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    for k in (attn, ffn):
        f, bw = launches.get(k.__name__, (0, 0))
        ff, fb = fit_launches[k.__name__]
        pf, pb = predict_launches[k.__name__]
        launches[k.__name__] = (f + ff + pf, bw + fb + pb)
    return launches, {"plate_step": st, "plate_layout": type(layout).__name__,
                      "plate_fit_s": run["fit_s"]}


#: phase 32: a row count of the hidden-128 FFN that is not a multiple of its
#: 128-row tile (1,001 nodes x 3 samples)
PANELS_TAIL = (1001, 3)
#: phase 34: panels trajectories of the fit (PANELS_FIT_FRAMES frames: frame
#: 0 is the first sample's previous frame, so 64 samples, one B=64 batch a
#: trajectory), one epoch, then a VAL_STEPS-step validation rollout
PANELS_FIT_TRAJECTORIES, PANELS_FIT_FRAMES, PANELS_FIT_EPOCHS = 3, 66, 1
FFN128 = {"name": "fused_gated_ffn_h128", "source": "graph_physics_tpu_torch/csrc/fused_ffn128.cu",
          "replaces": "graph_physics_tpu/ops/fused_ffn.py:74"}
FFN128_BWD = {"name": "fused_gated_ffn_h128_backward",
              "source": "graph_physics_tpu_torch/csrc/fused_ffn128_bwd.cu",
              "replaces": "graph_physics_tpu/ops/fused_ffn.py:99"}


def panels_kernel_checks(train, card, build_log):
    """Phase 32: rows 9 and 10 at hidden 128 with block 0's weights of the
    panels model, kernel against plain version at panels' shape and at
    ``PANELS_TAIL`` rows, the same bits on two calls, times and bounds and
    ptxas's report; rows 5 and 6 at panels' head width 32, checked and
    timed (attention_times_h32); with a parent tree, the hidden-64
    instance's bits against the parent's. Returns ({record name: rows 5/6's
    times at head width 32}, the two hidden-128 records without their
    launches)."""
    import torch
    from graph_physics_tpu_torch.models.layers import GatedMLPBlock, RMSNorm, reset_parameters
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.utils import gradcheck

    ffn, attn = ffn_ops.fused_gated_ffn, ea_ops.fused_edge_attention_nk
    sim, graph, nk = train.simulator, train.graph, train.tiling
    blk0 = sim.model.processor_list[0]
    mlp, norm2 = blk0.gated_mlp, blk0.norm2
    n, b = graph.x.shape[:2]
    hidden = sim.model.hidden_size
    heads = blk0.attention.num_heads
    gen = torch.Generator(device=graph.x.device).manual_seed(32)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=graph.x.device) * scale).to(
            torch.bfloat16)

    resources = kernel_resources(build_log, ("ffn128_",))
    for name, use in resources.items():
        log(f"ptxas, hidden-128 FFN kernel {name}: {use}")
    x, cot = randn(n, b, hidden), randn(n, b, hidden)
    tail = tuple(t[:PANELS_TAIL[0], :PANELS_TAIL[1]].contiguous() for t in (x, cot))
    cases = {"panels shape": (x, cot), "tail rows": tail}
    f_errs = []
    with torch.inference_mode():
        for label, (xx, _) in cases.items():
            before = ffn.launches
            y1, y2 = ffn(xx, mlp, norm2), ffn(xx, mlp, norm2)
            torch.cuda.synchronize()
            log(f"hidden-128 FFN forward kernel check [{label}: {xx.shape[0] * xx.shape[1]} rows, "
                f"{ffn.launches - before} launches]")
            if ffn.launches != before + 2:
                raise AssertionError("hidden-128 FFN: the forward kernel did not launch twice")
            if not torch.equal(y1, y2):
                raise AssertionError("hidden-128 FFN forward: other bits on a second call")
            f_errs.append(compare("y", y1, ffn_ops.gated_ffn_reference(xx, mlp, norm2), FFN_TOL))
            log("  the same bits on two calls")

    names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]

    def feed_forward(fn, m, n2):
        return lambda xx: (fn(xx, m, n2), ffn_ops._params(m, n2))

    b_errs = []
    for label, (xx, cc) in cases.items():
        before = ffn.backward_launches
        rows, ok, kept = gradcheck.check_backward(
            names, ("dx",), feed_forward(ffn, mlp, norm2),
            feed_forward(ffn_ops.reference_with_backward, mlp, norm2),
            feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(mlp),
                         gradcheck.rounded_copy(norm2)), [xx], [cc])
        torch.cuda.synchronize()
        log(f"hidden-128 FFN backward kernel check [{label}] (against the plain backward; both "
            f"against fp32)")
        log_grad_rows(rows)
        if ffn.backward_launches != before + 1:
            raise AssertionError("hidden-128 FFN: the backward kernel did not launch once")
        if not ok:
            raise AssertionError(f"hidden-128 FFN backward kernel [{label}] out of bounds")
        b_errs.append(max(r.get("max_abs_err", float("inf")) for r in rows))
        g1, g2 = (torch.autograd.grad(*kept["kernel"], retain_graph=True) for _ in range(2))
        if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
            raise AssertionError("hidden-128 FFN backward: other bits on a second call")
        log("  the same bits on two calls")
        if label == "panels shape":
            bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(*kept["plain"],
                                                               retain_graph=True))
        del kept

    def forward(fn):
        def run():
            with torch.inference_mode():
                fn(x, mlp, norm2)
        return run

    # both kernels at panels' shape (the parent's in turns with --parent),
    # and at PANELS_TAIL's rows
    t = ffn128_times(x, cot, mlp, norm2)
    t_tail = ffn128_times(tail[0], tail[1], mlp, norm2)
    fwd_plain_ms = cuda_ms(forward(ffn_ops.gated_ffn_reference))
    # x read and y written (bf16) and the fp32 weights read; 3 products of
    # H x 3H a row forward, 8 backward (x, g read, dx written, the weights
    # read and their fp32 gradients written)
    params = sum(p.numel() for p in ffn_ops._params(mlp, norm2))
    prods = 2 * n * b * hidden * 3 * hidden
    fwd_bound = bound(2 * 2 * x.numel() + 4 * params, 3 * prods)
    bwd_bound = bound(2 * 3 * x.numel() + 8 * params, 8 * prods)
    counted = ffn128_backward_bytes(n * b, params)
    for label, tt in (("panels shape", t), ("tail rows", t_tail)):
        log(f"  hidden-128 FFN [{label}]: forward kernel {tt['fwd_ms']:.4f} ms (device "
            f"{tt['fwd_device_ms']:.4f}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in tt["fwd_kernels"].items()) + "); backward kernel "
            f"{tt['bwd_ms']:.4f} ms (device {tt['bwd_device_ms']:.4f}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in tt["bwd_kernels"].items()) + f"), its peak allocation "
            f"{tt['bwd_peak_bytes']} bytes" + (
                "" if PARENT is None else
                f"; parent tree forward {tt['parent_fwd_ms']:.4f} ms (device "
                f"{tt['parent_fwd_device_ms']:.4f}), backward {tt['parent_bwd_ms']:.4f} ms "
                f"(device {tt['parent_bwd_device_ms']:.4f}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in tt["parent_bwd_kernels"].items()) +
                f"), its peak allocation {tt['parent_bwd_peak_bytes']} bytes; device time this "
                f"tree / parent: forward {tt['fwd_device_ms'] / tt['parent_fwd_device_ms']:.4f}, "
                f"backward {tt['bwd_device_ms'] / tt['parent_bwd_device_ms']:.4f}") + f" ({card})")
    log(f"  hidden-128 FFN at [{n}·{b}, {hidden}]: plain forward {fwd_plain_ms:.4f} ms, bound "
        f"{fwd_bound[0]:.6g} ms ({fwd_bound[1]}); plain backward {bwd_plain_ms:.4f} ms, bound "
        f"{bwd_bound[0]:.6g} ms ({bwd_bound[1]}); the backward's counted device-memory bytes "
        f"{counted} ({counted / 1e6:.1f} MB) ({card})")
    log("hidden-128 FFN times " + json.dumps({"card": card, "panels": t, "tail": t_tail,
                                              "counted_bytes": counted}))

    # rows 5 and 6 at panels' head width 32: forward and backward kernels
    # against their plain versions
    dh = hidden // heads
    q, k, v = (randn(n, b, heads, dh, scale=0.5) for _ in range(3))
    cot_a = randn(n, b, heads, dh)
    rows_a = (graph.senders, graph.receivers, graph.edge_mask)
    with torch.inference_mode():
        log(f"attention kernel check at panels' shape ({heads} heads of {dh})")
        compare("attention", attn(q, k, v, *rows_a, nk),
                ea_ops.fused_edge_attention_nk_reference(q, k, v, *rows_a, nk), ATTN_RTOL,
                atol=ATTN_ATOL)

    def attention(fn):
        return lambda *qkv: (fn(*qkv, *rows_a, nk), [])

    before = attn.backward_launches
    gk, _ = gradcheck.grads_of(attention(attn), (q, k, v), [cot_a])
    torch.cuda.synchronize()
    if attn.backward_launches != before + 1:
        raise AssertionError("panels attention: the backward kernel did not launch once")
    gp, _ = gradcheck.grads_of(attention(ea_ops.reference_with_backward), (q, k, v), [cot_a])
    gf, _ = gradcheck.grads_of(attention(ea_ops.fused_edge_attention_nk_reference),
                               (q.float(), k.float(), v.float()), [cot_a])
    a_rows, a_ok = gradcheck.compare_grads(("dq", "dk", "dv"), gk, gp, gf, ("dq", "dk", "dv"))
    log("attention backward kernel check at panels' shape (against the plain backward; both "
        "against fp32)")
    log_grad_rows(a_rows)
    if not a_ok:
        raise AssertionError("panels attention backward kernel out of bounds")
    del gk, gp, gf
    head32 = attention_times_h32(q, k, v, cot_a, graph, nk, heads, dh, card)

    if PARENT is not None:  # the hidden-64 instance keeps the parent's bits
        gen64 = torch.Generator().manual_seed(64)
        m64, n64 = GatedMLPBlock(64, 64, 64), RMSNorm(64)
        reset_parameters(m64, gen64)
        m64, n64 = m64.to(x.device), n64.to(x.device)
        x64, c64 = randn(n, b, 64), randn(n, b, 64)

        def fwd64():
            with torch.inference_mode():
                return ffn(x64, m64, n64)

        def bwd64():
            xl = x64.clone().requires_grad_(True)
            return torch.autograd.grad(ffn(xl, m64, n64), [xl, *ffn_ops._params(m64, n64)], c64)

        same_bits_as_parent("hidden-64 FFN forward", fwd64, ("ffn",))
        same_bits_as_parent("hidden-64 FFN backward", bwd64, ("ffn_bwd",))
    def parent_fields(way):
        return {} if PARENT is None else {"parent_ms": t[f"parent_{way}_ms"],
                                          "parent_device_ms": t[f"parent_{way}_device_ms"]}

    return head32, [
        dict(FFN128, route="cuda", launches=0, max_abs_err=max(f_errs), ms=t["fwd_ms"],
             plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
             library_ms=None, device_ms=t["fwd_device_ms"], kernels_device_ms=t["fwd_kernels"],
             tail_ms=t_tail["fwd_ms"], tail_device_ms=t_tail["fwd_device_ms"],
             **parent_fields("fwd"),
             ptxas={k: v for k, v in resources.items() if "bwd" not in k}),
        dict(FFN128_BWD, route="cuda", launches=0, max_abs_err=max(b_errs), ms=t["bwd_ms"],
             plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
             library_ms=None, device_ms=t["bwd_device_ms"], kernels_device_ms=t["bwd_kernels"],
             tail_ms=t_tail["bwd_ms"], tail_device_ms=t_tail["bwd_device_ms"],
             peak_bytes=t["bwd_peak_bytes"], counted_bytes=counted,
             **parent_fields("bwd"),
             ptxas={k: v for k, v in resources.items() if "bwd" in k}),
    ]


def attention_times_h32(q, k, v, cot, graph, nk, heads, dh, card):
    """Rows 5 and 6 at panels' shape (head width 32): the forward and one
    backward by CUDA events and the profiler's device time, their plain
    versions, the library's masked attention (dense, the mesh's adjacency
    as its boolean mask; forward, and forward + backward), and the bounds
    from these inputs (phases 11 and 14's). Returns {record name: fields}."""
    import torch
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops

    rows = (graph.senders, graph.receivers, graph.edge_mask)
    n, b = q.shape[:2]
    valid = int(graph.edge_mask.sum())
    with torch.inference_mode():
        fwd = dict(timed(lambda: ea_ops.fused_edge_attention_nk(q, k, v, *rows, nk), (),
                         device=True),
                   plain_ms=cuda_ms(lambda: ea_ops.fused_edge_attention_nk_reference(
                       q, k, v, *rows, nk)))
    fwd["library_ms"] = sdpa_ms((q, k, v), rows, n, False)
    bwd = dict(timed(attention_backward(ea_ops, (q, k, v), rows, nk, cot), (), device=True))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = ea_ops.reference_with_backward(*leaves, *rows, nk)
    bwd["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True))
    bwd["library_ms"] = sdpa_ms((q, k, v), rows, n, True, cot)
    del out, leaves
    fb = bound(2 * 4 * q.numel() + 5 * nk.total_rows, valid * b * heads * 4 * dh)
    bb = bound(2 * 7 * q.numel() + 5 * nk.total_rows, valid * b * heads * 10 * dh)
    fwd.update(bound_ms=fb[0], bound_by=fb[1], shape=[n, b, heads, dh])
    bwd.update(bound_ms=bb[0], bound_by=bb[1], shape=[n, b, heads, dh])
    for name, t in (("forward", fwd), ("backward", bwd)):
        log(f"  attention {name} at head width {dh}: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"with the adjacency mask {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6g} ms "
            f"({t['bound_by']}) ({card})")
    return {ATTN["name"]: fwd, ATTN_BWD["name"]: bwd}


def panels_phases(device, card, build_log):
    """Phases 32-34: the panels workload (training_config/panels.json: 15
    blocks, hidden 128, 4 heads of 32, bf16, the 4-term MultiLoss on
    least-squares gradients) at full width: the hidden-128 FFN kernels and
    the attention at its shape, 20 train steps at B=64 with 15 + 15
    launches of rows 5/6 and of rows 9/10 a step against the plain path,
    then Trainer.fit and predict. Returns the two hidden-128 records, with
    the launches of phases 33-34, {the attention wrapper's name: (forward,
    backward) launches} of phases 33-34, and {record name: times and bound
    of rows 5/6 at head width 32}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.dataset.xdmf_dataset import trajectory_fields
    from graph_physics_tpu_torch.external import get_feature_builder
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig

    attn, ffn = ea_ops.fused_edge_attention_nk, ffn_ops.fused_gated_ffn
    train = entry.panels_train_setup(device)
    g, layout = train.graph, train.tiling
    n_blocks = len(train.simulator.model.processor_list)
    log(f"panels: {int(g.n_node)} nodes ({g.x.shape[0]} rows) x {g.x.shape[1]} samples, "
        f"{g.x.shape[2]} features, {n_blocks} blocks, hidden {train.simulator.model.hidden_size}, "
        f"layout {type(layout).__name__} (K={getattr(layout, 'k_slots', None)}), "
        f"{int(g.face_mask.sum())} faces, loss {[t.name for t in train.loss_fn.losses]} "
        f"(weights {train.loss_fn.weights}, {train.gradient_method})")
    if not isinstance(layout, NKTiling):
        raise AssertionError(f"panels: FusedTopologyManager chose {type(layout).__name__}, "
                             "not the NK layout")

    # 32. rows 9 and 10 at hidden 128, rows 5 and 6 at head width 32
    head32, records = panels_kernel_checks(train, card, build_log)

    # 33. the panels train step: kernel path against the plain path, in
    # PyTorch's default mode (the physics loss's segment sums add in a fixed
    # order, ops/segment.py; by atomics they had moved the convection term's
    # later steps by ~6e-4 between runs of the same code, PERF.md §6)
    _, plain_state, plain_step, launches = training_phase("panels training", train,
                                                          [attn, ffn], 33)
    st = step_timing(train, plain_state, plain_step, 34)  # the parent has no hidden 128
    st = {k: v for k, v in st.items() if "parent" not in k}
    b = g.x.shape[1]
    log(f"panels train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, CUDA events "
        f"{st['train_step_enqueue_events_ms']:.4f} ms over the same steps, "
        f"{st['train_step_syncs']} device-to-host syncs a step), plain path "
        f"{st['train_step_plain_ms']:.4f} ms "
        f"({1000 * b / st['train_step_plain_ms']:.1f} graph-steps/s) ({card})")
    log("panels train timing " + json.dumps({"card": card, **st}))
    del train, plain_state, plain_step
    torch.cuda.empty_cache()

    # 34. panels through Trainer.fit (the CLI's stack) and predict, from
    # in-memory trajectories built as --external panels builds them
    param = config_lib.load_params(str(entry.PANELS_CONFIG))
    frame_cfg = config_lib.get_frame_config(param, use_previous_data=True,
                                            extra_node_features=get_feature_builder("panels"))

    def fields(frames):
        traj = synthetic.make_panels_trajectory(48, 40, frames)
        return trajectory_fields(traj["mesh_pos"], traj["cells"],
                                 {k: v for k, v in traj.items() if k not in ("mesh_pos", "cells")})

    ds = memory_dataset_class()
    train_ds = ds([fields(PANELS_FIT_FRAMES)] * PANELS_FIT_TRAJECTORIES,
                  synthetic.xdmf_meta_dict(PANELS_FIT_FRAMES, 0.2), frame_cfg)
    val_ds = ds([fields(VAL_STEPS + 2)], synthetic.xdmf_meta_dict(VAL_STEPS + 2, 0.2), frame_cfg)
    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
    lecun_parameters(sim, torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=PANELS_FIT_EPOCHS, batch_size=TF_FIT_BATCH, learning_rate=1e-3,
                        warmup=100, packed=True, fused=True,
                        out_dir=str(ROOT / "build" / "fit"), run_name="fit_panels", seed=0)
    shutil.rmtree(ROOT / "build" / "fit" / "fit_panels", ignore_errors=True)
    loss_fn, _ = config_lib.get_loss(param)
    tr = Trainer(sim, train_ds, val_ds, loss_fn, cfg,
                 gradient_method=config_lib.get_gradient_method(param),
                 noise_cfg=config_lib.get_noise_config(param), device=device)
    reset_counts([attn, ffn])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    fit_records = epoch_records(tr)
    steps = PANELS_FIT_EPOCHS * PANELS_FIT_TRAJECTORIES
    n_blocks = len(tr.sim.model.processor_list)
    log(f"fit, panels.json ({n_blocks} blocks, hidden {tr.sim.model.hidden_size}, bf16, "
        f"{type(tr.sim.model.tiling).__name__} layout, the 4-term MultiLoss; "
        f"{PANELS_FIT_TRAJECTORIES} trajectories of {PANELS_FIT_FRAMES} frames, B={TF_FIT_BATCH}, "
        f"{PANELS_FIT_EPOCHS} epoch, {tr.state.step} steps, validation {VAL_STEPS} rollout "
        f"steps): {fit_s:.1f} s ({card})")
    for r in fit_records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    want = (n_blocks * (tr.state.step + PANELS_FIT_EPOCHS * VAL_STEPS), n_blocks * tr.state.step)
    log("  launches (forward, backward): " + ", ".join(
        f"{k} {v}" for k, v in fit_launches.items()) + f"; expected {want} each")
    values = [r[k] for r in fit_records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(fit_records) != PANELS_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or tr.state.step != steps or any(v != want for v in fit_launches.values())):
        raise AssertionError(f"phase 34: {tr.state.step} steps, launches {fit_launches}, "
                             f"records {fit_records}")
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(entry.PANELS_CONFIG), "--model_path", tr.ckpt_dir,
        "--bf16", "--fused", "--external", "panels", "--device", str(device)])
    reset_counts([attn, ffn])
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    want_rmse = fit_records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, panels: checkpoint step {stack.step}, rollout of {pred.predictions.shape[0]} "
        f"steps, launches (forward, backward): " + ", ".join(
            f"{k} {v}" for k, v in predict_launches.items()) + f", expected {want} each: "
        f"rmse_all_rollout {pred.rmse_all_rollout:.8g}, validate reported {want_rmse:.8g} "
        f"(relative difference {rel:.3g}, limit {PREDICT_RTOL})")
    if (stack.step != steps or rel > PREDICT_RTOL
            or any(v != want for v in predict_launches.values())):
        raise AssertionError(f"phase 34: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    log("panels " + json.dumps({"card": card, "panels_step": st, "panels_fit_s": fit_s}))
    total = {k.__name__: tuple(sum(c[k.__name__][i] for c in (launches, fit_launches,
                                                              predict_launches))
                               for i in (0, 1)) for k in (attn, ffn)}
    records[0]["launches"], records[1]["launches"] = total[ffn.__name__]
    return records, {attn.__name__: total[attn.__name__]}, head32


# ---- phases 35-37: rows 1-4 at hidden 64 and 128; epd at MeshGraphNets' width ----

#: the widths of the wide GraphNetBlock kernels (csrc/gn_wide*.cuh, one
#: library a width and kernel)
WIDE_HIDDEN = (64, 128)
#: MeshGraphNets' latent size and message-passing steps for CylinderFlow,
#: Airfoil and DeformingPlate (Pfaff et al., ICLR 2021, arXiv:2010.03409,
#: §4 and Appendix A); training_config/cylinder.json cuts them to 32 and 5
MGN_HIDDEN, MGN_BLOCKS = 128, 15
#: phase 35: an odd batch (not a multiple of the 16-sample tile) on the
#: cylinder, and a hub graph: a receiver of in-degree HUB_DEGREE, receivers
#: with no row and with only masked rows, node N-1 owning rows
ODD_BATCH, HUB_NODES, HUB_RECEIVER, HUB_DEGREE, HUB_BATCH = 33, 384, 5, 150, 17
#: phase 36: steps of the graded CSR check at hidden 128 and of the
#: cylinder and graded checks at hidden 64
SHORT_STEPS = 5
#: phase 36: the batch of the comparison with the plain path at
#: MeshGraphNets' width: its fp32 step-1 gradients (step1_fp32_grads) at
#: B=128 would not fit in the card's 80 GB
MGN_PLAIN_BATCH = 32
#: phase 36: the steps of that comparison, held to LATER_LOSS_RTOL: at this
#: width the training is chaotic, and two plain runs a bf16 rounding of
#: their weights apart agree well within LATER_LOSS_RTOL over these first
#: steps only; at step 8 one card run came to 9.7e-4 (PERF.md §6;
#: tests/test_torch_cuda.py::
#: test_mgn_width_plain_training_repeats_itself_over_the_compared_steps)
MGN_COMPARED_STEPS = 7
#: phase 37: the fit of cylinder.json at MeshGraphNets' width: trajectories
#: of FIT_FRAMES frames (one B=128 batch each) and epochs
MGN_FIT_TRAJECTORIES, MGN_FIT_EPOCHS = 2, 1


def wide_record(layout, h, backward):
    """The kernels-line keys naming rows 1-4 at hidden ``h``."""
    row = {("nk", False): "graph_physics_tpu/ops/fused_gnblock_nk.py:147",
           ("nk", True): "graph_physics_tpu/ops/fused_gnblock_nk.py:189",
           ("csr", False): "graph_physics_tpu/ops/fused_gnblock.py:392",
           ("csr", True): "graph_physics_tpu/ops/fused_gnblock.py:453"}[layout, backward]
    return {"name": f"fused_gn_block_{layout}_h{h}" + ("_backward" if backward else ""),
            "source": f"graph_physics_tpu_torch/csrc/fused_gnblock_wide_{layout}"
                      + ("_bwd" if backward else "") + ".cu",
            "replaces": row}


def hub_graph(device, seed=0):
    """The row arrays and CSR layout of a HUB_NODES-node graph: receiver
    HUB_RECEIVER of in-degree HUB_DEGREE, receivers 10-19 with no row, 20-29 with only
    masked rows, node N-1 with 9 rows, the others 1 to 6 rows from random
    senders."""
    import numpy as np
    import torch
    from graph_physics_tpu_torch.ops.tiling import build_csr_layout

    rng = np.random.default_rng(seed)
    n = HUB_NODES
    degree = rng.integers(1, 7, n)
    degree[HUB_RECEIVER], degree[10:20], degree[n - 1] = HUB_DEGREE, 0, 9
    receivers = np.repeat(np.arange(n), degree)
    rng.shuffle(receivers)
    senders = rng.integers(0, n, receivers.size)
    layout = build_csr_layout(senders, receivers, n)
    valid = layout.perm >= 0
    ids = layout.perm[valid]
    s_rows, r_rows = np.zeros(layout.total_rows, np.int32), np.full(layout.total_rows, n - 1,
                                                                     np.int32)
    s_rows[valid], r_rows[valid] = senders[ids], receivers[ids]
    m_rows = valid & ~np.isin(r_rows, np.arange(20, 30))

    def dev(a):
        return torch.as_tensor(a, device=device).contiguous()

    return (dev(s_rows), dev(r_rows), dev(m_rows)), layout


def wide_block_checks(label, kernel, rows, layout, blocks, enc, x, e, raw, card, timing=True):
    """Rows 1-4 (``kernel``, a layout's wrapper) at one width and shape:
    each variant (folded, middle, last) of ``blocks`` against its plain
    version forward (KERNEL_TOL) and backward (utils/gradcheck.py, every
    stream value held against the plain backward, a hub's too), the
    backward's bits on two calls; with ``timing``, each variant's times
    (with a parent tree, the parent's beside them). Returns (forward
    errors, backward errors, forward times, backward times) by variant."""
    import torch
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.utils import gradcheck

    plain = (nk_ops.fused_gn_block_nk_reference if kernel is nk_ops.fused_gn_block_nk
             else csr_ops.fused_gn_block_csr_reference)
    gen = torch.Generator(device=x.device).manual_seed(35)
    variants = {"folded": (blocks[0], raw, enc, False), "middle": (blocks[1], e, None, False),
                "last": (blocks[-1], e, None, True)}
    f_err, b_err, f_t, b_t = {}, {}, {}, {}
    for name, (blk, ee, en, last) in variants.items():
        args = (x, ee, *rows, blk.edge_block, blk.node_block, layout)
        kw = dict(encoder_params=en, last_block=last)
        with torch.inference_mode():
            before = kernel.launches
            xk, ek = kernel(*args, **kw)
            xp, ep = plain(*args, **kw, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            log(f"{label} forward kernel check [{name}] ({kernel.launches - before} launch)")
            if kernel.launches != before + 1:
                raise AssertionError(f"{label} [{name}]: the forward kernel did not launch once")
            f_err[name] = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:
                f_err[name] = max(f_err[name], compare("e_out", ek, ep, KERNEL_TOL))
            del xk, ek, xp, ep
            if timing:
                f_t[name] = dict(timed(lambda: late(kernel)(*args, **kw),
                                       gn_libs(layout_name(kernel), x.shape[-1], False),
                                       device=True),
                                 plain_ms=cuda_ms(lambda: plain(*args, **kw,
                                                                compute_dtype=torch.bfloat16)))
                log(f"  time: kernel {f_t[name]['ms']:.4f} ms (device "
                    f"{f_t[name]['device_ms']:.4f}), plain {f_t[name]['plain_ms']:.4f} ms "
                    f"({card})")
        cot_x = (torch.randn(x.shape, generator=gen, device=x.device)).to(torch.bfloat16)
        cot_e = (torch.randn((layout.total_rows,) + x.shape[1:], generator=gen,
                             device=x.device)).to(torch.bfloat16)
        before = kernel.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x, ee, rows, (en, blk.edge_block, blk.node_block), layout, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"{label} backward kernel check [{name}] ({kernel.backward_launches - before} "
            f"launch; against the plain backward, both against fp32)")
        log_grad_rows(grad_rows)
        if kernel.backward_launches != before + 1:
            raise AssertionError(f"{label} [{name}]: the backward kernel did not launch once")
        if not ok:
            raise AssertionError(f"{label} [{name}]: backward kernel out of bounds")
        b_err[name] = max(r.get("max_abs_err", float("inf")) for r in grad_rows)
        g1, g2 = (torch.autograd.grad(*kept["kernel"], retain_graph=True) for _ in range(2))
        if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
            raise AssertionError(f"{label} [{name}]: the backward gives other bits on a second "
                                 "call")
        log(f"  the backward's {len(g1)} gradients: the same bits on two calls")
        del g1, g2
        if timing:
            b_t[name] = backward_times(
                f"{label} backward [{name}]",
                lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True),
                lambda: torch.autograd.grad(*kept["plain"], retain_graph=True),
                gn_libs(layout_name(kernel), x.shape[-1], True), card)
        del kept
        torch.cuda.empty_cache()
    return f_err, b_err, f_t, b_t


def wide_kernel_phase(device, card, build_log):
    """Phase 35: rows 1-4 at hidden 64 and 128, every variant, in both
    layouts, at the cylinder NK shape (B=128) and the graded CSR shape
    (B=16), then at an odd batch and on a hub graph; ptxas's registers and
    spills; with a parent tree, the hidden-32 instances' bits against the
    parent's. Returns {record name: record} without launches."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    resources = kernel_resources(build_log, ("gnw",))
    for name, use in resources.items():
        log(f"ptxas, wide GraphNetBlock kernel {name}: {use}")
    gen = torch.Generator(device=device).manual_seed(350)

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)

    records = {}
    for h in WIDE_HIDDEN:
        for layout in ("nk", "csr"):
            if layout == "nk":
                setup = entry.cylinder_setup(device, hidden=h, mp_steps=3)
                kernel = nk_ops.fused_gn_block_nk
                rows = (setup.graph.senders, setup.graph.edge_mask)
            else:
                setup = entry.graded_setup(device, hidden=h, mp_steps=3)
                kernel = csr_ops.fused_gn_block_csr
                rows = (setup.graph.senders, setup.graph.receivers, setup.graph.edge_mask)
            model, lay = setup.simulator.model, setup.tiling
            n, b = setup.graph.x.shape[:2]
            label = f"hidden {h}, {layout.upper()} [{n}, {b}]"
            x, e, raw = randn(n, b, h), randn(lay.total_rows, b, h), randn(lay.total_rows, b, 3)
            f_err, b_err, f_t, b_t = wide_block_checks(
                label, kernel, rows, lay, model.processor_list, model.edges_encoder, x, e, raw,
                card)
            blk = model.processor_list[1]
            fb = bound(*gn_block_work(x, e, setup.graph.edge_mask, blk))
            bb = bound(*gn_block_work(x, e, setup.graph.edge_mask, blk, backward=True))
            log(f"{label}: middle block forward {f_t['middle']['ms']:.4f} ms (device "
                f"{f_t['middle']['device_ms']:.4f}), bound {fb[0]:.6g} ms ({fb[1]})"
                f"{parent_note(f_t['middle'])}; backward "
                f"{b_t['middle']['ms']:.4f} ms (device {b_t['middle']['device_ms']:.4f}), bound "
                f"{bb[0]:.6g} ms ({bb[1]}){parent_note(b_t['middle'])} ({card})")
            for backward, errs, times, bd in ((False, f_err, f_t, fb), (True, b_err, b_t, bb)):
                rec = wide_record(layout, h, backward)
                keep = [k for k in resources if (("bwd" in k or "send" in k or "wgrad" in k
                                                  or "wsum" in k) == backward
                                                 or "partial" in k or "enc_fwd" in k)
                        and (f"_{layout}_" in k or ("_nk_" not in k and "_csr_" not in k))]
                records[rec["name"]] = dict(
                    rec, route="cuda", launches=0, max_abs_err=max(errs.values()),
                    ms=times["middle"]["ms"], plain_ms=times["middle"]["plain_ms"],
                    bound_ms=bd[0], bound_by=bd[1], library_ms=None,
                    device_ms=times["middle"]["device_ms"], variants=times,
                    ptxas={k: resources[k] for k in keep if f"gnw{h}_" in k},
                    **{k: v for k, v in times["middle"].items() if k.startswith("parent_")})
            del setup, x, e, raw
            torch.cuda.empty_cache()
        # an odd batch on the cylinder (NK), and the hub graph (CSR)
        odd = entry.cylinder_setup(device, hidden=h, mp_steps=3, batch=ODD_BATCH)
        n = odd.graph.x.shape[0]
        f_err, b_err, _, _ = wide_block_checks(
            f"hidden {h}, NK, odd batch [{n}, {ODD_BATCH}]", nk_ops.fused_gn_block_nk,
            (odd.graph.senders, odd.graph.edge_mask), odd.tiling, odd.simulator.model.processor_list,
            odd.simulator.model.edges_encoder, randn(n, ODD_BATCH, h),
            randn(odd.tiling.total_rows, ODD_BATCH, h), randn(odd.tiling.total_rows, ODD_BATCH, 3),
            card, timing=False)
        for bwd, errs in ((False, f_err), (True, b_err)):
            r = records[wide_record("nk", h, bwd)["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], max(errs.values()))
        hub_rows, hub = hub_graph(device)
        f_err, b_err, _, _ = wide_block_checks(
            f"hidden {h}, CSR hub graph [{HUB_NODES}, {HUB_BATCH}] (in-degree {HUB_DEGREE})",
            csr_ops.fused_gn_block_csr, hub_rows, hub, odd.simulator.model.processor_list,
            odd.simulator.model.edges_encoder, randn(hub.num_nodes, HUB_BATCH, h),
            randn(hub.total_rows, HUB_BATCH, h), randn(hub.total_rows, HUB_BATCH, 3), card,
            timing=False)
        for bwd, errs in ((False, f_err), (True, b_err)):
            r = records[wide_record("csr", h, bwd)["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], max(errs.values()))
        del odd
    if PARENT is not None:  # the hidden-32 instances keep the parent tree's bits
        for layout in ("nk", "csr"):
            setup = (entry.cylinder_setup(device, batch=ODD_BATCH) if layout == "nk"
                     else entry.graded_setup(device))
            g, lay, model = setup.graph, setup.tiling, setup.simulator.model
            ops = nk_ops if layout == "nk" else csr_ops
            name = f"fused_gn_block_{layout}"
            # the wrapper by name at each call: the parent's, in its turns
            kernel = lambda *a, **k: getattr(ops, name)(*a, **k)  # noqa: E731
            rows = ((g.senders, g.edge_mask) if layout == "nk"
                    else (g.senders, g.receivers, g.edge_mask))
            n, b = g.x.shape[:2]
            x, raw = randn(n, b, 32), randn(lay.total_rows, b, 3)
            e, cot_x, cot_e = randn(lay.total_rows, b, 32), randn(n, b, 32), randn(
                lay.total_rows, b, 32)
            folded, middle = model.processor_list[0], model.processor_list[1]

            def fwd():
                with torch.inference_mode():
                    return kernel(x, raw, *rows, folded.edge_block, folded.node_block, lay,
                                  encoder_params=model.edges_encoder)

            def bwd():  # dx and de: the parent's weight gradients are atomic sums
                xl, el = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
                xo, eo = kernel(xl, el, *rows, middle.edge_block, middle.node_block, lay)
                return torch.autograd.grad([xo, eo], [xl, el], [cot_x, cot_e])

            same_bits_as_parent(f"hidden-32 {layout.upper()} forward (folded)", fwd,
                                (f"gn_{layout}_fwd",))
            same_bits_as_parent(f"hidden-32 {layout.upper()} backward (middle: dx, de)", bwd,
                                (f"gn_{layout}_fwd", f"gn_{layout}_bwd"))
            del setup
    return records


def mgn_train_phase(device, card):
    """Phase 36: ``epd`` at MeshGraphNets' width (hidden 128, 15 blocks,
    NK) through entry.cylinder_train_setup: TRAIN_STEPS steps at B=128
    with 15 + 15 launches of rows 1/2 a step, their peak memory, and the
    step's wall, enqueue and device time; the first MGN_COMPARED_STEPS
    steps at B=MGN_PLAIN_BATCH against the plain path (training_phase),
    with both paths' peak memory; then SHORT_STEPS steps against the plain path of
    the graded mesh's ``epd`` at hidden 128 (B=16, CSR, rows 3/4) and of
    the cylinder's and the graded mesh's at hidden 64. Returns
    ({(layout, width): (forward, backward) launches}, the B=128 step's
    times)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    gn, csr = nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr
    launches = {}
    train = entry.cylinder_train_setup(device, hidden=MGN_HIDDEN, mp_steps=MGN_BLOCKS)
    g = train.graph
    b = g.x.shape[1]
    log(f"MeshGraphNets-width epd: {int(g.n_node)} nodes x {b} samples, hidden {MGN_HIDDEN}, "
        f"{MGN_BLOCKS} blocks, {type(train.tiling).__name__} layout (K={train.tiling.k_slots}), "
        f"{sum(p.numel() for p in train.simulator.parameters())} parameters")
    reset_counts([gn])
    torch.cuda.reset_peak_memory_stats()
    losses, norms, per_step, _, _ = train_run(train.train_step, train.state, train.simulator,
                                              g, 36, TRAIN_STEPS, [gn])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches["nk", MGN_HIDDEN] = launch_counts(gn)
    log(f"MGN-width epd training ({TRAIN_STEPS} steps, B={b}, kernel path): launches per step "
        f"(forward, backward) {sorted(set(per_step))}, in all {launches['nk', MGN_HIDDEN]}; "
        f"max_memory_allocated {peak / 2**30:.4f} GiB")
    log("  loss:      " + " ".join(f"{v:.6g}" for v in losses))
    log("  grad_norm: " + " ".join(f"{v:.6g}" for v in norms))
    if any(s != ((MGN_BLOCKS, MGN_BLOCKS),) for s in per_step) or not all(
            map(math.isfinite, losses + norms)):
        raise AssertionError(f"phase 36: launches per step {per_step}, or a non-finite loss "
                             "or gradient norm")
    st = step_timing(train, None, None, 37, libs=gn_libs("nk", MGN_HIDDEN, True))
    log(f"MGN-width train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, CUDA events "
        f"{st['train_step_enqueue_events_ms']:.4f} ms over the same steps, "
        f"{st['train_step_syncs']} device-to-host syncs a step){parent_step_note(st)} ({card})")
    log("MGN-width train timing " + json.dumps({"card": card, "peak_bytes": peak, **st}))
    del train
    torch.cuda.empty_cache()
    checks = (
        (f"MGN-width epd training at B={MGN_PLAIN_BATCH} against the plain path", gn,
         ("nk", MGN_HIDDEN), lambda: entry.cylinder_train_setup(
             device, hidden=MGN_HIDDEN, mp_steps=MGN_BLOCKS, batch=MGN_PLAIN_BATCH),
         MGN_COMPARED_STEPS),
        (f"graded epd training at hidden {MGN_HIDDEN}", csr, ("csr", MGN_HIDDEN),
         lambda: entry.graded_train_setup(device, hidden=MGN_HIDDEN), SHORT_STEPS),
        ("cylinder epd training at hidden 64", gn, ("nk", 64),
         lambda: entry.cylinder_train_setup(device, hidden=64, mp_steps=MGN_BLOCKS),
         SHORT_STEPS),
        ("graded epd training at hidden 64", csr, ("csr", 64),
         lambda: entry.graded_train_setup(device, hidden=64), SHORT_STEPS))
    for seed, (label, kernel, key, make, steps) in enumerate(checks, start=38):
        setup = make()
        _, _, _, got = training_phase(label, setup, [kernel], seed, steps=steps)
        launches[key] = tuple(a + c for a, c in zip(launches.get(key, (0, 0)),
                                                    got[kernel.__name__]))
        del setup, got
        torch.cuda.empty_cache()
    return launches, st


def mgn_fit_phase(device, card):
    """Phase 37: training_config/cylinder.json with hidden_size 128 and
    message_passing_num 15 (set in memory) through Trainer.fit
    (MGN_FIT_TRAJECTORIES trajectories, B=128, MGN_FIT_EPOCHS epoch, a
    VAL_STEPS-step validation rollout), then predict from its checkpoint:
    the launches counted and held to the prediction, predict's RMSE
    validate's. Returns the (forward, backward) launches of both."""
    import torch
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    gn = nk_ops.fused_gn_block_nk
    param = cylinder_param()
    param["model"].update(hidden_size=MGN_HIDDEN, message_passing_num=MGN_BLOCKS)
    train_ds, val_ds = fit_datasets(MGN_FIT_TRAJECTORIES)
    tr = fit_trainer(param, train_ds, val_ds, "fit_mgn", device, epochs=MGN_FIT_EPOCHS)
    reset_counts([gn])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts(gn)
    steps, n_blocks = tr.state.step, len(tr.sim.model.processor_list)
    records = epoch_records(tr)
    log(f"fit, cylinder.json at MeshGraphNets' width ({n_blocks} blocks, hidden "
        f"{tr.sim.model.hidden_size}, bf16, {type(tr.sim.model.tiling).__name__} layout; "
        f"{MGN_FIT_TRAJECTORIES} trajectories of {FIT_FRAMES} frames, B={FIT_BATCH}, "
        f"{MGN_FIT_EPOCHS} epoch, {steps} steps, validation {VAL_STEPS} rollout steps): "
        f"{fit_s:.1f} s ({card})")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    want = (n_blocks * (steps + MGN_FIT_EPOCHS * VAL_STEPS), n_blocks * steps)
    log(f"  launches (forward, backward) of {gn.__name__}: {fit_launches}; expected {want}")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(records) != MGN_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or n_blocks != MGN_BLOCKS or steps != MGN_FIT_EPOCHS * MGN_FIT_TRAJECTORIES
            or fit_launches != want):
        raise AssertionError(f"phase 37: {steps} steps, launches {fit_launches}, records "
                             f"{records}")
    # predict reads the configuration from a file: the in-memory one, written
    # beside the run's checkpoints
    cfg_path = Path(tr.cfg.out_dir) / tr.cfg.run_name / "cylinder_mgn.json"
    cfg_path.write_text(json.dumps(param))
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
        "--fused", "--device", str(device)])
    reset_counts([gn])
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = launch_counts(gn)
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, cylinder.json at MeshGraphNets' width: checkpoint step {stack.step}, rollout "
        f"of {pred.predictions.shape[0]} steps, launches (forward, backward) {predict_launches}, "
        f"expected {want}: rmse_all_rollout {pred.rmse_all_rollout:.8g}, validate reported "
        f"{want_rmse:.8g} (relative difference {rel:.3g}, limit {PREDICT_RTOL})")
    if stack.step != steps or rel > PREDICT_RTOL or predict_launches != want:
        raise AssertionError("phase 37: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    log("MGN-width fit " + json.dumps({"card": card, "fit_s": fit_s, "fit_launches": fit_launches,
                                       "predict_launches": predict_launches,
                                       "predict_rmse": pred.rmse_all_rollout,
                                       "validate_rmse": want_rmse}))
    return tuple(a + c for a, c in zip(fit_launches, predict_launches))


def wide_phases(device, card, build_log):
    """Phases 35-37; returns the eight records of rows 1-4 at hidden 64 and
    128, each with the launches of the runs at its width."""
    records = wide_kernel_phase(device, card, build_log)
    launches, _ = mgn_train_phase(device, card)
    fit = mgn_fit_phase(device, card)
    launches["nk", MGN_HIDDEN] = tuple(a + c for a, c in zip(launches["nk", MGN_HIDDEN], fit))
    for (layout, h), (fwd_n, bwd_n) in launches.items():
        records[wide_record(layout, h, False)["name"]]["launches"] += fwd_n
        records[wide_record(layout, h, True)["name"]]["launches"] += bwd_n
    return [records[wide_record(layout, h, bwd)["name"]] for h in WIDE_HIDDEN
            for layout in ("nk", "csr") for bwd in (False, True)]


# ---- phases 38-40: the GraphNetBlock kernels' world seam; DeformingPlate's MeshGraphNet ----

#: phase 38: the widths of rows 1-4 that take the world seam (``extra_agg``)
SEAM_HIDDEN = (32, 64, 128)
#: phase 39: the steps over which DeformingPlate's MeshGraphNet on the
#: kernel path is held to the plain path at LATER_LOSS_RTOL: the plain path
#: repeats itself over these (tests/test_torch_cuda.py::
#: test_plate_epd_plain_training_repeats_itself_over_the_compared_steps)
PLATE_EPD_COMPARED_STEPS = 7
#: phase 40: epochs of the plate MeshGraphNet's fit (PLATE_FIT_TRAJECTORIES
#: trajectories of PLATE_FIT_FRAMES frames, one B=64 batch each)
PLATE_EPD_FIT_EPOCHS = 1


def gn_record_name(layout, h, backward):
    """The kernels-line name of row 1-4 (``layout``, ``backward``) at
    hidden ``h``."""
    if h in WIDE_HIDDEN:
        return wide_record(layout, h, backward)["name"]
    return {("nk", False): FWD, ("nk", True): BWD, ("csr", False): GN_CSR,
            ("csr", True): GN_CSR_BWD}[layout, backward]["name"]


def seam_phase(device, card):
    """Phase 38: the world seam of rows 1-4 at hidden 32, 64 and 128, at
    the cylinder NK shape (1,920 nodes x 128 samples) and the graded CSR
    shape (27,008 x 16), with a dense random extra aggregate: each forward
    variant against its plain version (KERNEL_TOL), the middle block's
    backward (dx, de, dea and every weight gradient) against its plain
    backward and fp32 autograd (utils/gradcheck.py), a zero extra giving
    the bits of none forward and backward; the middle block's times with
    and without the extra (CUDA events, the profiler's device time), the
    plain version's, and the bound with the extra's traffic. Returns
    {record name: world fields}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.utils import gradcheck

    gen = torch.Generator(device=device).manual_seed(38)

    def randn(*shape, scale=0.5):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)

    out = {}
    for layout in ("nk", "csr"):
        for h in SEAM_HIDDEN:
            if layout == "nk":
                setup = entry.cylinder_setup(device, hidden=h, mp_steps=3)
                kernel, plain = nk_ops.fused_gn_block_nk, nk_ops.fused_gn_block_nk_reference
                rows = (setup.graph.senders, setup.graph.edge_mask)
            else:
                setup = entry.graded_setup(device, hidden=h, mp_steps=3)
                kernel, plain = csr_ops.fused_gn_block_csr, csr_ops.fused_gn_block_csr_reference
                rows = (setup.graph.senders, setup.graph.receivers, setup.graph.edge_mask)
            model, lay = setup.simulator.model, setup.tiling
            n, b = setup.graph.x.shape[:2]
            label = f"world seam, hidden {h}, {layout.upper()} [{n}, {b}]"
            x, e = randn(n, b, h), randn(lay.total_rows, b, h)
            raw, extra = randn(lay.total_rows, b, 3), randn(n, b, h, scale=0.3)
            cot_x, cot_e = randn(n, b, h, scale=1.0), randn(lay.total_rows, b, h, scale=1.0)
            blocks = model.processor_list
            variants = {"folded": (blocks[0], raw, model.edges_encoder, False),
                        "middle": (blocks[1], e, None, False),
                        "last": (blocks[-1], e, None, True)}
            f_err = {}
            with torch.inference_mode():
                for name, (blk, ee, enc, last) in variants.items():
                    args = (x, ee, *rows, blk.edge_block, blk.node_block, lay)
                    kw = dict(encoder_params=enc, last_block=last)
                    before = kernel.launches
                    xk, ek = kernel(*args, **kw, extra_agg=extra)
                    xp, ep = plain(*args, **kw, extra_agg=extra, compute_dtype=torch.bfloat16)
                    torch.cuda.synchronize()
                    log(f"{label} forward kernel check [{name}] "
                        f"({kernel.launches - before} launch)")
                    if kernel.launches != before + 1:
                        raise AssertionError(f"{label} [{name}]: the kernel did not launch once")
                    f_err[name] = compare("x_out", xk, xp, KERNEL_TOL)
                    if not last:  # a folded block's padded rows hold enc(raw): valid rows
                        valid = rows[-1] if enc is not None else None
                        f_err[name] = max(f_err[name], compare("e_out", ek, ep, KERNEL_TOL,
                                                               rows=valid))
                    del xk, ek, xp, ep
                blk = blocks[1]
                args = (x, e, *rows, blk.edge_block, blk.node_block, lay)
                zero = [kernel(*args, extra_agg=torch.zeros_like(extra)), kernel(*args)]
                if not all(torch.equal(a, c) for a, c in zip(*zero)):
                    raise AssertionError(f"{label}: a zero extra_agg changes the forward's bits")
                del zero
                t = dict(timed(lambda: kernel(*args, extra_agg=extra), (), device=True),
                         plain_ms=cuda_ms(lambda: plain(*args, extra_agg=extra,
                                                        compute_dtype=torch.bfloat16)))
                mesh = timed(lambda: kernel(*args), (), device=True)
            log(f"  middle block: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}) with the "
                f"extra, {mesh['ms']:.4f} ms (device {mesh['device_ms']:.4f}) without; plain "
                f"{t['plain_ms']:.4f} ms ({card})")
            before = kernel.backward_launches
            grad_rows, ok, kept = gradcheck.check_block_backward(
                x, e, rows, (None, blk.edge_block, blk.node_block), lay, False, cot_x, cot_e,
                extra=extra)
            torch.cuda.synchronize()
            log(f"{label} backward kernel check [middle] ({kernel.backward_launches - before} "
                "launch; dx, de, dea against the plain backward, all against fp32)")
            log_grad_rows(grad_rows)
            if kernel.backward_launches != before + 1 or not ok:
                raise AssertionError(f"{label}: the backward kernel did not launch once, or is "
                                     "out of bounds")
            params = [p for m in (blk.edge_block, blk.node_block) for p in nk_ops._mlp_params(m)]

            def graph(xa):  # a retained kernel-path graph, with the extra or without
                xl, el = x.clone().requires_grad_(True), e.clone().requires_grad_(True)
                leaves = [xl, el] + ([] if xa is None else [xa.clone().requires_grad_(True)])
                xo, eo = kernel(xl, el, *args[2:], extra_agg=leaves[2] if xa is not None
                                else None)
                return [xo, eo], leaves + params, [cot_x, cot_e]

            runs = [torch.autograd.grad(*graph(xa)) for xa in (None, torch.zeros_like(extra))]
            if not all(torch.equal(a, c) for a, c in zip(runs[0], runs[1][:2] + runs[1][3:])):
                raise AssertionError(f"{label}: a zero extra_agg changes the backward's bits")
            del runs
            log("  a zero extra_agg gives the bits of none, forward and backward")
            bt = backward_times(f"{label} backward [middle]",
                                lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True),
                                lambda: torch.autograd.grad(*kept["plain"], retain_graph=True),
                                (), card)
            kept_none = graph(None)
            fn_none = lambda: torch.autograd.grad(*kept_none, retain_graph=True)  # noqa: E731
            bmesh = {"ms": cuda_ms(fn_none), "device_ms": device_ms(fn_none)}
            log(f"  middle backward without the extra: {bmesh['ms']:.4f} ms (device "
                f"{bmesh['device_ms']:.4f}) ({card})")
            extra_bytes = 2 * extra.numel()  # read by the forward, dea written by the backward
            fw, bw = (gn_block_work(x, e, setup.graph.edge_mask, blk, backward=bwd)
                      for bwd in (False, True))
            fb, bb = bound(fw[0] + extra_bytes, fw[1]), bound(bw[0] + extra_bytes, bw[1])
            for backward, err, tt, tm, bd in ((False, max(f_err.values()), t, mesh, fb),
                                             (True, max(r.get("max_abs_err", float("inf"))
                                                        for r in grad_rows), bt, bmesh, bb)):
                out[gn_record_name(layout, h, backward)] = dict(
                    max_abs_err=err, ms=tt["ms"], device_ms=tt["device_ms"],
                    plain_ms=tt["plain_ms"], mesh_ms=tm["ms"], mesh_device_ms=tm["device_ms"],
                    bound_ms=bd[0], bound_by=bd[1], shape=[n, b, h])
            log(f"{label}: bounds with the extra forward {fb[0]:.6g} ms ({fb[1]}), backward "
                f"{bb[0]:.6g} ms ({bb[1]})")
            del setup, x, e, raw, extra, cot_x, cot_e, kept, kept_none
            torch.cuda.empty_cache()
    return out


def plate_epd_train_phase(device, card):
    """Phase 39: DeformingPlate's MeshGraphNet (entry.plate_epd_train_setup:
    hidden 128, 15 blocks, B=64 frames from those with world edges, NK)
    with 15 + 15 launches of rows 1/2 a step, held to the plain path over
    the first PLATE_EPD_COMPARED_STEPS steps (training_phase); the kernel
    path's peak memory and the step's wall, enqueue and device time.
    Returns ((forward, backward) launches, the step's times)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling

    gn = nk_ops.fused_gn_block_nk
    train = entry.plate_epd_train_setup(device)
    g, layout = train.graph, train.tiling
    b = g.x.shape[1]
    per_sample = g.wedge_mask.sum(0)
    log(f"plate MeshGraphNet: {type(layout).__name__} layout ({layout.num_nodes} nodes, "
        f"{layout.total_rows} slots, K={getattr(layout, 'k_slots', None)}); B={b} frames of "
        f"{list(entry.PLATE_WORLD_FRAMES)}, {int(per_sample.sum())} world edges over "
        f"{g.wedge_mask.shape[0]} slots a sample ({int(per_sample.min())} to "
        f"{int(per_sample.max())} a sample); hidden {train.simulator.model.hidden_size}, "
        f"{len(train.simulator.model.processor_list)} blocks, "
        f"{sum(p.numel() for p in train.simulator.parameters())} parameters")
    if not isinstance(layout, NKTiling) or not bool((per_sample > 0).all()):
        raise AssertionError("phase 39: the plate batch is not in the NK layout, or a sample "
                             "has no world edge")
    # rows 1/2's bounds at this shape: a middle block with the world
    # aggregate read by the forward and its cotangent written by the backward
    blk, h = train.simulator.model.processor_list[1], train.simulator.model.hidden_size
    x = torch.empty((g.x.shape[0], b, h), device="meta", dtype=torch.bfloat16)
    e = torch.empty((g.edge_mask.shape[0], b, h), device="meta", dtype=torch.bfloat16)
    bounds = {}
    for backward in (False, True):
        nbytes, flops = gn_block_work(x, e, g.edge_mask, blk, backward=backward)
        ms, by = bound(nbytes + 2 * x.numel(), flops)
        bounds[gn_record_name("nk", h, backward)] = {"bound_ms": ms, "bound_by": by,
                                                     "shape": [g.x.shape[0], b, h]}
    log("plate MeshGraphNet's middle block, bounds with the world aggregate: " + ", ".join(
        f"{k} {v['bound_ms']:.6g} ms ({v['bound_by']})" for k, v in bounds.items()))
    _, plain_state, plain_step, launches = training_phase(
        "plate MeshGraphNet training", train, [gn], 39, steps=PLATE_EPD_COMPARED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(40)
    for _ in range(2):
        train.train_step(train.state, g, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st = step_timing(train, plain_state, plain_step, 41)
    log(f"plate MeshGraphNet train step B={b}: kernel path {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms, CUDA events "
        f"{st['train_step_enqueue_events_ms']:.4f} ms over the same steps, "
        f"{st['train_step_syncs']} device-to-host syncs a step; max_memory_allocated "
        f"{peak / 2**30:.4f} GiB), plain path {st['train_step_plain_ms']:.4f} ms ({card})")
    log("plate MeshGraphNet train timing " + json.dumps({"card": card, "peak_bytes": peak,
                                                          **st}))
    del train, plain_state, plain_step
    torch.cuda.empty_cache()
    return launches[gn.__name__], st, bounds


def plate_epd_fit_phase(device, card):
    """Phase 40: plate.json with DeformingPlate's MeshGraphNet as its model
    (entry.plate_epd_block, set in memory) through Trainer.fit on in-memory
    plate trajectories (PLATE_FIT_TRAJECTORIES of PLATE_FIT_FRAMES frames,
    B=64, PLATE_EPD_FIT_EPOCHS epoch, a VAL_STEPS-step validation rollout),
    then predict from its checkpoint: the launches of rows 1/2 (or 3/4, on
    a topology the manager lays out as CSR) held to the prediction,
    predict's RMSE validate's. Returns {wrapper name: (forward, backward)
    launches} of both."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training import config as config_lib

    gns = (nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr)
    param = plate_param()
    param["model"] = entry.plate_epd_block()
    ds = memory_dataset_class()
    frame_cfg = entry.plate_frame_config()
    trajs = [synthetic.make_plate_trajectory(44 + i, 30, PLATE_FIT_FRAMES)
             for i in range(PLATE_FIT_TRAJECTORIES)]
    train_ds = ds(trajs, synthetic.plate_meta_dict(PLATE_FIT_FRAMES), frame_cfg)
    val_ds = ds([synthetic.make_plate_trajectory(44, 30, VAL_STEPS + 1)],
                synthetic.plate_meta_dict(VAL_STEPS + 1), frame_cfg)
    _, world_dev = config_lib.get_world_configs(param)
    tr = fit_trainer(param, train_ds, val_ds, "fit_plate_epd", device, batch=TF_FIT_BATCH,
                     epochs=PLATE_EPD_FIT_EPOCHS, world_pos=world_dev)
    reset_counts(gns)
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {k.__name__: launch_counts(k) for k in gns}
    steps, n_blocks = tr.state.step, len(tr.sim.model.processor_list)
    records = epoch_records(tr)
    log(f"fit, plate.json with DeformingPlate's MeshGraphNet ({n_blocks} blocks, hidden "
        f"{tr.sim.model.hidden_size}, bf16, world edges as each frame's sidecar; "
        f"{PLATE_FIT_TRAJECTORIES} trajectories of {PLATE_FIT_FRAMES} frames, B={TF_FIT_BATCH}, "
        f"{PLATE_EPD_FIT_EPOCHS} epoch, {steps} steps, validation {VAL_STEPS} rollout steps): "
        f"{fit_s:.1f} s ({card})")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    total = tuple(map(sum, zip(*fit_launches.values())))
    want = (n_blocks * (steps + PLATE_EPD_FIT_EPOCHS * VAL_STEPS), n_blocks * steps)
    log(f"  launches (forward, backward): {fit_launches}; in all {total}, expected {want}")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(records) != PLATE_EPD_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or steps != PLATE_EPD_FIT_EPOCHS * PLATE_FIT_TRAJECTORIES or total != want):
        raise AssertionError(f"phase 40: {steps} steps, launches {fit_launches}, records "
                             f"{records}")
    # predict reads the configuration from a file: the in-memory one, written
    # beside the run's checkpoints
    cfg_path = Path(tr.cfg.out_dir) / tr.cfg.run_name / "plate_epd.json"
    cfg_path.write_text(json.dumps(param))
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
        "--fused", "--device", str(device)])
    reset_counts(gns)
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {k.__name__: launch_counts(k) for k in gns}
    total = tuple(map(sum, zip(*predict_launches.values())))
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, plate MeshGraphNet: checkpoint step {stack.step}, rollout of "
        f"{pred.predictions.shape[0]} steps, launches (forward, backward) {predict_launches}, "
        f"in all {total}, expected {want}: rmse_all_rollout {pred.rmse_all_rollout:.8g}, "
        f"validate reported {want_rmse:.8g} (relative difference {rel:.3g}, limit "
        f"{PREDICT_RTOL})")
    if stack.step != steps or rel > PREDICT_RTOL or total != want:
        raise AssertionError("phase 40: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    log("plate MeshGraphNet fit " + json.dumps({
        "card": card, "fit_s": fit_s, "fit_launches": fit_launches,
        "predict_launches": predict_launches, "predict_rmse": pred.rmse_all_rollout,
        "validate_rmse": want_rmse}))
    return {k: tuple(a + c for a, c in zip(fit_launches[k], predict_launches[k]))
            for k in fit_launches}


def plate_epd_phases(device, card):
    """Phases 38-40; returns ({record name: world fields}, {record name:
    launches of phases 39-40}, {record name: its bound at the plate
    MeshGraphNet's shape})."""
    world = seam_phase(device, card)
    train_launches, _, bounds = plate_epd_train_phase(device, card)
    counts = {"nk": list(train_launches), "csr": [0, 0]}
    for name, launches in plate_epd_fit_phase(device, card).items():
        for i, n in enumerate(launches):
            counts["nk" if name == "fused_gn_block_nk" else "csr"][i] += n
    return world, {gn_record_name(layout, MGN_HIDDEN, backward): c[backward]
                   for layout, c in counts.items() for backward in (False, True)}, bounds



# ---- phases 41-43: the world-edge and rollout options --------------------

#: phase 41: trajectories (obstacle descents entry.PLATE_DESCENTS) rolled
#: out from frame 0, and steps: over the contact frames of the synthetic
#: 44x30 plate (6-13 at JAX's descent)
DYN_TRAJECTORIES, DYN_STEPS = 8, 16
#: phase 41: a pair whose squared distance lies within this share of r² of
#: it sits on the radius: fp32 rounding may put it on either side
RADIUS_BAND = 1e-6
#: phase 42: the aneurysm mesh (nodes: 44 x 32 = 1,408, the plate's count)
#: and the fit's trajectories (2 of ANEURYSM_FIT_FRAMES frames: one B=64
#: batch each, frame 0 being the first sample's previous frame)
ANEURYSM_MESH = (44, 32)
ANEURYSM_FIT_TRAJECTORIES, ANEURYSM_FIT_FRAMES = 2, 66
#: phase 43: frames of the plate trajectory the concat-layout run trains on
#: (contact frames, so the frames' edge arrays hold world edges), B
CONCAT_FRAMES, CONCAT_BATCH = range(6, 10), 2


@contextlib.contextmanager
def recorded_searches():
    """Every call of training/rollout.apply_dynamic_world_edges, recorded
    as (the positions searched, [N, R, 3], and the sidecar it wrote:
    senders, receivers, mask [W, R]); yields the list."""
    from graph_physics_tpu_torch.training import rollout as rollout_lib

    calls, original = [], rollout_lib.apply_dynamic_world_edges

    def record(g, cfg, true_x=None):
        out = original(g, cfg, true_x=true_x)
        src = g.x if (cfg.track_predicted or true_x is None) else true_x
        calls.append((src[..., cfg.world_pos_start:cfg.world_pos_end].float().clone(),
                      out.wedge_senders.clone(), out.wedge_receivers.clone(),
                      out.wedge_mask.clone()))
        return out

    rollout_lib.apply_dynamic_world_edges = record
    try:
        yield calls
    finally:
        rollout_lib.apply_dynamic_world_edges = original


def pair_sets(senders, receivers, mask):
    """[{(sender, receiver)} of trajectory r] of a [W, R] sidecar."""
    s, r, m = (t.cpu().numpy() for t in (senders, receivers, mask))
    return [set(zip(s[m[:, i], i].tolist(), r[m[:, i], i].tolist())) for i in range(s.shape[1])]


def check_searches(label, calls, setup, model, card):
    """Holds each recorded search of the card to ops/knn.radius_edges on the
    CPU for the same positions: the same pairs, apart from pairs on the
    radius (RADIUS_BAND), which are counted. With the ground-truth track
    the pairs are also the host sidecar's (core/mesh.radius_world_edges,
    which leaves out mesh edges) plus the in-radius mesh edges joining
    {OBSTACLE, HANDLE} with NORMAL nodes (which JAX's device search keeps),
    wherever neither the cap nor the budget binds. Returns the counts."""
    import numpy as np
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.core import mesh as mesh_lib
    from graph_physics_tpu_torch.core.nodetype import NodeType
    from graph_physics_tpu_torch.ops.knn import radius_edges

    cfg = setup.rollout_kw["dynamic_world_edges"]
    g = setup.frames
    t = g.node_type.cpu()
    obs = (((t == int(NodeType.OBSTACLE)) | (t == int(NodeType.HANDLE)))
           & g.node_mask.cpu())
    nrm = (t == int(NodeType.NORMAL)) & g.node_mask.cpu()
    r2 = cfg.radius * cfg.radius
    host = None
    if not cfg.track_predicted:  # each frame's host sidecar at the search's radius
        host = [[pair_sets(*(torch.as_tensor(np.asarray(getattr(f, k))[:, None]) for k in
                             ("wedge_senders", "wedge_receivers", "wedge_mask")))[0]
                 for f in entry.plate_frames(traj, range(len(calls)), 2 * cfg.budget,
                                             cfg.radius, model=model)]
                for traj in setup.trajectories]
        n_mesh = int(setup.host[0].n_node)
        ei = mesh_lib.faces_to_edges(setup.trajectories[0]["cells"][0], n_mesh)
        mesh_edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    counts = dict(pairs=0, differing=0, on_radius=0, mesh_pairs=0, capped_or_full=0)
    for step, (wp, send, recv, mask) in enumerate(calls):
        card_sets = pair_sets(send, recv, mask)
        wp = wp.cpu()
        for r, got in enumerate(card_sets):
            pos = wp[:, r]
            a, b, valid, capped = radius_edges(pos, pos, cfg.radius, cfg.budget, mask_a=obs,
                                               mask_b=nrm, k_per_node=cfg.k_per_node,
                                               with_stats=True)
            a, b = a[valid].tolist(), b[valid].tolist()
            want = set(zip(a, b)) | set(zip(b, a))
            p64 = pos.double()
            d2 = ((p64[obs][:, None] - p64[nrm][None]) ** 2).sum(-1)
            counts["on_radius"] += int(((d2 - r2).abs() <= RADIUS_BAND * r2).sum())
            counts["pairs"] += len(got)

            def off_radius(pairs):
                return [(i, j) for i, j in pairs
                        if abs(float(((p64[i] - p64[j]) ** 2).sum()) - r2) > RADIUS_BAND * r2]

            diff = got ^ want
            counts["differing"] += len(diff)
            if off_radius(diff):
                raise AssertionError(f"{label}, step {step}, trajectory {r}: the card's pairs "
                                     f"differ from the CPU's off the radius: "
                                     f"{sorted(off_radius(diff))[:8]}")
            if host is not None:
                in_mesh = {p for p in want if p in mesh_edges}
                counts["mesh_pairs"] += len(in_mesh)
                if int(capped) or len(a) == cfg.budget:
                    counts["capped_or_full"] += 1
                    continue
                expected = host[r][step] | in_mesh
                if off_radius(got ^ expected):
                    raise AssertionError(f"{label}, step {step}, trajectory {r}: the pairs are "
                                         "not the host sidecar's and the in-radius mesh edges")
    log(f"  {label}: {len(calls)} searches x {len(card_sets)} trajectories, "
        f"{counts['pairs']} directed world edges found on the card, the CPU's radius_edges on "
        f"the same positions: {counts['differing']} differ, {counts['on_radius']} candidate "
        f"pairs within {RADIUS_BAND:g} of r²" + (
            f"; the host sidecar's pairs plus {counts['mesh_pairs']} in-radius mesh edges "
            f"({counts['capped_or_full']} searches capped or full, not compared)"
            if host is not None else "") + f" ({card})")
    return counts


def dynamic_world_phase(device, card):
    """Phase 41: DeformingPlate rolled out with its world edges found again
    at every step (entry.plate_rollout_setup: DYN_TRAJECTORIES trajectories
    from frame 0, DYN_STEPS steps, 1,024 sidecar slots), plate.json's
    transformer (rows 5 and 9, NK) and its MeshGraphNet (row 1 with the
    world aggregate, hidden 128, 15 blocks), in both tracks: the card's
    pairs against the CPU's (check_searches), the launches against the
    count predicted, the kernel path's RMSE within ROLLOUT_RTOL of the
    plain path's; a rollout step's time with and without the search, and
    the search's own. Returns ({wrapper name: (forward, backward)}, times)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as gn_csr
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as gn_nk
    from graph_physics_tpu_torch.ops.tiling import NKTiling
    from graph_physics_tpu_torch.training import rollout as rollout_lib

    launches, times = defaultdict(lambda: [0, 0]), {}
    for model in ("transformer", "epd"):
        wrappers = ((ea_nk.fused_edge_attention_nk, ffn_ops.fused_gated_ffn)
                    if model == "transformer" else (gn_nk.fused_gn_block_nk,))
        others = ((ea_csr.fused_edge_attention_csr,) if model == "transformer"
                  else (gn_csr.fused_gn_block_csr,))
        for track in (True, False):
            label = f"{model} {'predicted' if track else 'ground truth'} track"
            setup = entry.plate_rollout_setup(device, model=model, trajectories=DYN_TRAJECTORIES,
                                              steps=DYN_STEPS, track_predicted=track)
            sim, frames = setup.simulator, setup.frames
            n_blocks = len(sim.model.processor_list)
            if not isinstance(setup.tiling, NKTiling) or frames.wedge_mask.any():
                raise AssertionError(f"phase 41 [{label}]: not the NK layout, or the frames' "
                                     "sidecars hold pairs where they should only reserve slots")
            rollout = rollout_lib.make_batched_rollout_fn(sim, **setup.rollout_kw)
            reset_counts((*wrappers, *others))
            with recorded_searches() as calls:
                res = rollout(frames)
                torch.cuda.synchronize()
            got = {k.__name__: launch_counts(k) for k in (*wrappers, *others)}
            want = {k.__name__: (n_blocks * DYN_STEPS, 0) for k in wrappers}
            want.update({k.__name__: (0, 0) for k in others})
            log(f"dynamic world edges [{label}]: {n_blocks} blocks, hidden "
                f"{sim.model.hidden_size}, R={DYN_TRAJECTORIES}, T={DYN_STEPS}, "
                f"{frames.wedge_mask.shape[1]} slots a sample; launches {got}, predicted {want}")
            if got != want or len(calls) != DYN_STEPS:
                raise AssertionError(f"phase 41 [{label}]: launches {got}, expected {want}; "
                                     f"{len(calls)} searches")
            for name, (f, b) in got.items():
                launches[name][0] += f
                launches[name][1] += b
            counts = check_searches(label, calls, setup, model, card)
            plain = rollout_lib.make_batched_rollout_fn(plain_copy(sim), **setup.rollout_kw)
            res_plain = plain(frames)
            rk, rp = res.rmse_all_rollout.tolist(), res_plain.rmse_all_rollout.tolist()
            worst = max(abs(a - c) / abs(c) for a, c in zip(rk, rp))
            log(f"  rmse_all_rollout, kernel path: " + " ".join(f"{v:.6g}" for v in rk))
            log(f"  rmse_all_rollout, plain path:  " + " ".join(f"{v:.6g}" for v in rp)
                + f"; max relative difference {worst:.6g} (limit {ROLLOUT_RTOL})")
            if not (torch.isfinite(res.predictions).all() and all(map(math.isfinite, rk + rp))
                    and worst <= ROLLOUT_RTOL):
                raise AssertionError(f"phase 41 [{label}]: the rollout is not finite or off "
                                     "the plain path")
            entry_times = {"rmse": rk, "plain_rmse": rp, "counts": counts}
            if track:  # the times: a step with and without the search, the search alone
                static = {k: v for k, v in setup.rollout_kw.items()
                          if k != "dynamic_world_edges"}
                without = rollout_lib.make_batched_rollout_fn(sim, **static)
                cfg = setup.rollout_kw["dynamic_world_edges"]
                step = frames.replace(x=frames.x[0], y=frames.y[0],
                                      **{k: getattr(frames, k)[0] for k in
                                         ("wedge_senders", "wedge_receivers", "wedge_mask",
                                          "wedge_attr")})

                def search():
                    rollout_lib.apply_dynamic_world_edges(step, cfg)

                # device time from a 2-step window: the profiler's sessions
                # over a whole rollout (~10^4 events each) are slow to read back
                short = frames.replace(x=frames.x[:2], y=frames.y[:2], **{
                    k: getattr(frames, k)[:2] for k in ("wedge_senders", "wedge_receivers",
                                                        "wedge_mask", "wedge_attr")})
                entry_times.update(
                    step_ms=cuda_ms(lambda: rollout(frames), warmup=1, reps=5) / DYN_STEPS,
                    step_without_ms=cuda_ms(lambda: without(frames), warmup=1,
                                            reps=5) / DYN_STEPS,
                    search_ms=cuda_ms(search), search_device_ms=device_ms(search),
                    step_device_ms=device_ms(lambda: rollout(short), reps=2) / 2,
                    step_without_device_ms=device_ms(lambda: without(short), reps=2) / 2)
                log(f"  a rollout step (R={DYN_TRAJECTORIES}): {entry_times['step_ms']:.4f} ms "
                    f"(device {entry_times['step_device_ms']:.4f}) with the search, "
                    f"{entry_times['step_without_ms']:.4f} ms (device "
                    f"{entry_times['step_without_device_ms']:.4f}) without; the search "
                    f"{entry_times['search_ms']:.4f} ms (device "
                    f"{entry_times['search_device_ms']:.4f}) ({card})")
            times[label] = entry_times
            del setup, sim, frames, res, res_plain, calls
            torch.cuda.empty_cache()
    return {k: tuple(v) for k, v in launches.items()}, times


def aneurysm_phase(device, card):
    """Phase 42: coarse-aneurysm.json and pinn-aneurysm.json (10 blocks,
    hidden 64, 4 heads, ``--external aneurysm``) through Trainer.fit on
    in-memory synthetic aneurysm trajectories (ANEURYSM_MESH), the
    validation rollout carrying the acceleration columns of x
    (``--use_previous_data`` on entry.aneurysm_previous_data's columns),
    then predict from the checkpoint as ``cli.predict --use_previous_data
    --bf16 --fused`` runs it: the launches of rows 5/6 and 9/10 (7/8 where
    the layout is CSR) held to the prediction, finite losses, predict's
    RMSE validate's; the kernel path's rollout against the plain path's,
    and the plain path with the carry against the plain path without.
    Returns ({wrapper name: (forward, backward)}, facts)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.ops.tiling import NKTiling
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn
    from graph_physics_tpu_torch.training.trainer import (
        Trainer,
        TrainerConfig,
        rollout_graph,
        trajectory_graph,
    )

    ffn = ffn_ops.fused_gated_ffn
    attns = (ea_nk.fused_edge_attention_nk, ea_csr.fused_edge_attention_csr)
    launches, facts = defaultdict(lambda: [0, 0]), {}
    ds = memory_dataset_class()
    for config in ("coarse", "pinn"):
        param = entry.aneurysm_param(config)
        frame_cfg = entry.aneurysm_frame_config(config)
        fields = entry.aneurysm_fields(*ANEURYSM_MESH, ANEURYSM_FIT_FRAMES)
        prev = entry.aneurysm_previous_data(fields)
        meta = synthetic.xdmf_meta_dict(ANEURYSM_FIT_FRAMES, entry.ANEURYSM_DT)
        train_ds = ds([fields] * ANEURYSM_FIT_TRAJECTORIES, meta, frame_cfg)
        val_ds = ds([entry.aneurysm_fields(*ANEURYSM_MESH, VAL_STEPS + 2)],
                    synthetic.xdmf_meta_dict(VAL_STEPS + 2, entry.ANEURYSM_DT), frame_cfg)
        sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
        lecun_parameters(sim, torch.Generator().manual_seed(0))
        run = f"fit_{config}_aneurysm"
        cfg = TrainerConfig(epochs=1, batch_size=TF_FIT_BATCH, learning_rate=1e-3, warmup=100,
                            packed=True, fused=True, out_dir=str(ROOT / "build" / "fit"),
                            run_name=run, seed=0, previous_data_slice=prev)
        shutil.rmtree(ROOT / "build" / "fit" / run, ignore_errors=True)
        loss_fn, _ = config_lib.get_loss(param)
        tr = Trainer(sim, train_ds, val_ds, loss_fn, cfg,
                     gradient_method=config_lib.get_gradient_method(param),
                     noise_cfg=config_lib.get_noise_config(param), device=device)
        reset_counts([*attns, ffn])
        t0 = time.perf_counter()
        tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        layout = tr.sim.model.tiling
        attn = attns[0] if isinstance(layout, NKTiling) else attns[1]
        fit_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
        records = epoch_records(tr)
        steps, n_blocks = tr.state.step, len(tr.sim.model.processor_list)
        want = (n_blocks * (steps + VAL_STEPS), n_blocks * steps)
        log(f"fit, {config}-aneurysm.json ({n_blocks} blocks, hidden {tr.sim.model.hidden_size}, "
            f"bf16, {type(layout).__name__} layout, loss {config_lib.get_loss(param)[1]}, "
            f"--external aneurysm, previous data {prev}; {int(val_ds.get_frame(0, 1).n_node)} "
            f"nodes, {ANEURYSM_FIT_TRAJECTORIES} trajectories of {ANEURYSM_FIT_FRAMES} frames, "
            f"B={TF_FIT_BATCH}, {steps} steps, validation {VAL_STEPS} rollout steps): "
            f"{fit_s:.1f} s ({card})")
        for r in records:
            log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
                f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
                f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
        log("  launches (forward, backward): " + ", ".join(
            f"{k} {v}" for k, v in fit_launches.items()) + f"; expected {want} each")
        values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
        if (len(records) != 1 or not all(math.isfinite(v) for v in values)
                or steps != ANEURYSM_FIT_TRAJECTORIES
                or any(v != want for v in fit_launches.values())):
            raise AssertionError(f"phase 42 [{config}]: {steps} steps, launches {fit_launches}, "
                                 f"records {records}")
        cfg_path = Path(tr.cfg.out_dir) / run / f"{config}-aneurysm.json"
        cfg_path.write_text(json.dumps(param))
        args = predict_cli.build_argparser().parse_args([
            "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
            "--fused", "--external", "aneurysm", "--use_previous_data", "--previous_data_start",
            str(prev[0]), "--previous_data_end", str(prev[1]), "--device", str(device)])
        reset_counts([*attns, ffn])
        stack = load_inference_stack(args, dataset=val_ds)
        pred = predict_cli.predict(stack, fused=True)[0]
        torch.cuda.synchronize()
        predict_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
        want_rmse = records[-1]["val_all_rollout_rmse"]
        rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
        want_p = (n_blocks * VAL_STEPS, 0)
        log(f"predict, {config}-aneurysm: previous data {stack.previous_data_slice}, rollout of "
            f"{pred.predictions.shape[0]} steps, launches (forward, backward): " + ", ".join(
                f"{k} {v}" for k, v in predict_launches.items()) + f", expected {want_p} each: "
            f"rmse_all_rollout {pred.rmse_all_rollout:.8g}, validate reported {want_rmse:.8g} "
            f"(relative difference {rel:.3g}, limit {PREDICT_RTOL})")
        if (stack.previous_data_slice != prev or rel > PREDICT_RTOL
                or any(v != want_p for v in predict_launches.values())):
            raise AssertionError(f"phase 42 [{config}]: predict's rollout is not validate's, or "
                                 f"its launches {predict_launches} are not {want_p}")
        # the kernel path against the plain path, and the carry's effect
        frames = rollout_graph([trajectory_graph(val_ds, 0, FusedTopologyManager("transformer"))],
                               device)
        tr.sim.model.tiling = frames.layout
        reset_counts([*attns, ffn])
        res = make_batched_rollout_fn(tr.sim, previous_data_slice=prev)(frames)
        torch.cuda.synchronize()
        extra = {k.__name__: launch_counts(k) for k in (attn, ffn)}
        plain = plain_copy(tr.sim)
        res_plain = make_batched_rollout_fn(plain, previous_data_slice=prev)(frames)
        res_off = make_batched_rollout_fn(plain)(frames)
        rk, rp, ro = (float(r.rmse_all_rollout[0]) for r in (res, res_plain, res_off))
        worst = abs(rk - rp) / rp
        moved = (res_plain.predictions - res_off.predictions).abs().max().item()
        log(f"  rollout rmse_all_rollout: kernel path {rk:.8g}, plain path {rp:.8g} (relative "
            f"difference {worst:.6g}, limit {ROLLOUT_RTOL}); plain path without the carry "
            f"{ro:.8g}, its predictions at most {moved:.6g} from the carry's")
        if not (all(map(math.isfinite, (rk, rp, ro))) and worst <= ROLLOUT_RTOL and moved > 0):
            raise AssertionError(f"phase 42 [{config}]: the rollout is off the plain path, or "
                                 "the carry changes nothing")
        for k in (attn, ffn):
            for counts in (fit_launches, predict_launches, extra):
                launches[k.__name__][0] += counts[k.__name__][0]
                launches[k.__name__][1] += counts[k.__name__][1]
        facts[config] = {"fit_s": fit_s, "layout": type(layout).__name__,
                         "predict_rmse": pred.rmse_all_rollout, "validate_rmse": want_rmse,
                         "kernel_rmse": rk, "plain_rmse": rp, "no_carry_rmse": ro,
                         "carry_moves": moved, "previous_data": list(prev)}
        del tr, stack, frames, res, res_plain, res_off, plain
        torch.cuda.empty_cache()
    return {k: tuple(v) for k, v in launches.items()}, facts


def concat_phase(device, card):
    """Phase 43: plate.json unpacked, its world edges in the concat layout
    (each frame's budgeted world edges after its mesh edges, stacked per
    sample), CONCAT_BATCH frames a step through Trainer.fit on the plain
    path: 2 steps, finite losses, no kernel launch."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig, WorldConfig
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.loss import l2_loss
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig

    param = plate_param()
    wrappers = (ea_nk.fused_edge_attention_nk, ea_csr.fused_edge_attention_csr,
                ffn_ops.fused_gated_ffn)
    frame_cfg = FrameConfig(targets=("world_pos",), world=WorldConfig(
        world_pos_index_start=0, world_pos_index_end=3, node_type_index=entry.PLATE_NODE_TYPE,
        radius=entry.PLATE_RADIUS, edge_budget=entry.PLATE_BUDGET))
    traj = synthetic.make_plate_trajectory(44, 30, max(CONCAT_FRAMES) + 1)
    traj = {k: v[CONCAT_FRAMES.start:] for k, v in traj.items()}
    ds = memory_dataset_class()([traj], synthetic.plate_meta_dict(len(CONCAT_FRAMES)), frame_cfg)
    g = ds.get_frame(0, 0, train=False)
    mesh = ds.builder.mesh_edges(0, traj["cells"][0], int(g.n_node)).shape[1]
    sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
    lecun_parameters(sim, torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=1, batch_size=CONCAT_BATCH, learning_rate=1e-3, warmup=100,
                        out_dir=str(ROOT / "build" / "fit"), run_name="fit_concat", seed=0)
    shutil.rmtree(ROOT / "build" / "fit" / "fit_concat", ignore_errors=True)
    _, world_dev = config_lib.get_world_configs(param)
    tr = Trainer(sim, ds, None, l2_loss, cfg, noise_cfg=config_lib.get_noise_config(param),
                 world_pos=world_dev, device=device)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    records = epoch_records(tr)
    got = {k.__name__: launch_counts(k) for k in wrappers}
    log(f"concat layout: plate.json unpacked, frames {list(CONCAT_FRAMES)} of the 44x30 plate, "
        f"{int(g.n_edge)} edges in frame {CONCAT_FRAMES.start}'s arrays ({mesh} mesh edges, "
        f"{g.senders.shape[0]} slots), B={CONCAT_BATCH} stacked, {tr.state.step} steps on the "
        f"plain path: train_loss_epoch {records[-1]['train_loss_epoch']:.6g}, launches {got}, "
        f"{fit_s:.1f} s ({card})")
    if (tr.state.step != 2 or not math.isfinite(records[-1]["train_loss_epoch"])
            or int(g.n_edge) <= mesh or any(v != (0, 0) for v in got.values())):
        raise AssertionError(f"phase 43: {tr.state.step} steps, records {records}, launches "
                             f"{got}, {int(g.n_edge)} edges against {mesh} mesh edges")
    return {"steps": tr.state.step, "edges": int(g.n_edge), "mesh_edges": mesh, "fit_s": fit_s}


def option_phases(device, card):
    """Phases 41-43; returns ({wrapper name: (forward, backward) launches}
    of phases 41-42, the facts of each)."""
    dyn_launches, dyn = dynamic_world_phase(device, card)
    log("dynamic world edges " + json.dumps({"card": card, **dyn}))
    an_launches, aneurysm = aneurysm_phase(device, card)
    log("aneurysm " + json.dumps({"card": card, **aneurysm}))
    concat = concat_phase(device, card)
    log("concat " + json.dumps({"card": card, **concat}))
    return merge_launches(dyn_launches, an_launches)


#: phase 44: the sub-mesh workload's mesh (128 x 64 = 8,192 nodes), the
#: training trajectory's frames (16 samples a part: one B=16 batch a part)
#: and the two fits' partitions: 4 parts, and parts of at most 3,000 nodes
#: (3 parts, of 2,731, 2,730 and 2,731 nodes)
SUBMESH_MESH = (128, 64)
SUBMESH_FRAMES, SUBMESH_BATCH = 17, 16
SUBMESH_RUNS = ({"num_partitions": 4}, {"max_nodes_per_partition": 3000})
#: phase 45: the aneurysm sub-meshes' node cap (1,408 nodes: 3 parts)
ANEURYSM_PART_NODES = 512
#: phases 44-45: host batches timed on the loader, each way
LOADER_BATCHES = 8


@contextlib.contextmanager
def plain_native():
    """The host mesh library's functions replaced by their plain (numpy)
    versions while the block runs, for the loader's timings."""
    from graph_physics_tpu_torch import native

    saved = {name: getattr(native, name) for name in native.PLAIN}
    for name, fn in native.PLAIN.items():
        setattr(native, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def library_checks(label, traj):
    """Each function of the host mesh library against its plain version on
    the mesh of ``traj`` (a trajectory dict), exactly: pair searches as
    sorted sets at twice the median edge length, the packing functions on
    four frames of its first dynamic field. Returns {function: ms of the
    library, ms of the plain version}."""
    import numpy as np
    from graph_physics_tpu_torch import native

    pos = np.asarray(traj["mesh_pos"][0], np.float32)
    cells, n = traj["cells"][0], len(traj["mesh_pos"][0])
    ei = native.faces_to_edges(cells, n)
    radius = float(2 * np.median(np.linalg.norm(pos[ei[0]] - pos[ei[1]], axis=1)))
    key = next(k for k in traj if k not in ("cells", "mesh_pos", "node_type"))
    vals = [np.ascontiguousarray(traj[key][i], np.float32) for i in range(4)]
    block = np.ascontiguousarray(np.stack(vals))
    w = block.shape[-1]

    def pack_block(fn):
        out = np.zeros((n + 7, 4, w + 2), np.float32)
        fn(block, out, 1)
        return out

    def pairs(p):
        return p[np.lexsort((p[:, 1], p[:, 0]))]

    cases = {
        "faces_to_edges": (lambda f: f(cells, n), None),
        "k_hop": (lambda f: f(ei, n, 2), None),
        "radius_pairs": (lambda f: f(pos, radius), pairs),
        "radius_cross_pairs": (lambda f: f(pos[::7], pos[1::7], radius), pairs),
        "rcb_labels": (lambda f: [f(pos, p) for p in (3, 4)], None),
        "pack_rows": (lambda f: f(vals), None),
        "repeat_rows": (lambda f: f(vals[0], 16), None),
        "pack_block": (pack_block, None),
    }
    times, bad = {}, []
    for name, (call, canon) in cases.items():
        t0 = time.perf_counter()
        got = call(getattr(native, name))
        t1 = time.perf_counter()
        want = call(native.PLAIN[name])
        t2 = time.perf_counter()
        if canon is not None:
            got = canon(got)
        same = all(np.array_equal(a, b) for a, b in zip(
            got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]))
        if not same:
            bad.append(name)
        times[name] = (1000 * (t1 - t0), 1000 * (t2 - t1))
    log(f"{label}: host mesh library against its plain versions on {n} nodes ({ei.shape[1]} "
        f"edges, radius {radius:.4g}): " + ", ".join(
            f"{k} {a:.3f} ms / {b:.3f} ms" for k, (a, b) in times.items())
        + ("; all equal" if not bad else f"; DIFFER: {bad}"))
    if bad:
        raise AssertionError(f"{label}: the library differs from its plain version in {bad}")
    return times


def loader_host_ms(ds, batch, family):
    """Host milliseconds of one packed batch of ``ds`` laid out for
    ``family`` (the fit's loader: frames built, laid out, packed), the mean
    over LOADER_BATCHES batches after one that builds the layouts."""
    from graph_physics_tpu_torch.dataset.loader import BatchLoader
    from graph_physics_tpu_torch.training.fused import FusedTopologyManager

    mgr = FusedTopologyManager(family)
    loader = BatchLoader(ds, batch, seed=0, packed=True, device_put=False,
                         frame_transform=mgr.transform_frame,
                         packed_transform=mgr.transform_packed)
    chunks = loader._batched_indices()
    for c in chunks[:len(set(ds.indices_for(i)[2] for i in range(len(ds))))]:
        loader.host_batch(c)  # each part's layout and skeleton built once
    chunks = list(itertools.islice(itertools.cycle(chunks), LOADER_BATCHES))
    t0 = time.perf_counter()
    for c in chunks:
        loader.host_batch(c)
    return 1000 * (time.perf_counter() - t0) / len(chunks)


def loader_times(label, make_ds, batch, family):
    """The loader's host ms a batch and the dataset's set-up ms (mesh edges,
    partitions), with partitions and without, on the library and on its
    plain versions."""
    out = {}
    for parts in (True, False):
        for lib in ("library", "plain"):
            with plain_native() if lib == "plain" else contextlib.nullcontext():
                t0 = time.perf_counter()
                ds = make_ds(parts)
                setup = 1000 * (time.perf_counter() - t0)
                out[f"{'parts' if parts else 'whole'}_{lib}"] = {
                    "batch_host_ms": loader_host_ms(ds, batch, family), "setup_ms": setup}
    log(f"{label}: loader host ms a B={batch} batch (set-up ms of the dataset): " + ", ".join(
        f"{k} {v['batch_host_ms']:.3f} ({v['setup_ms']:.1f})" for k, v in out.items()))
    return out


def step_losses(trainer):
    path = Path(trainer.cfg.out_dir) / trainer.cfg.run_name / f"{trainer.cfg.run_name}.metrics.jsonl"
    return [r["loss"] for r in map(json.loads, path.read_text().splitlines()) if "loss" in r]


def submesh_fit(label, param, train_ds, val_ds, device, card, batch, run, groups,
                loss_fn, gradient_method=None, prev=None, predict_flags=()):
    """Trainer.fit of ``param``'s model (bf16, weights from seed 0, packed,
    the fused layouts) on the sub-meshes of ``train_ds``, one epoch, the
    validation rollout on the full mesh of ``val_ds``; then the same fit
    with every batch on the plain path (same layouts, batches, noise and
    weights; both fits in PyTorch's default mode), and predict from
    the kernel fit's checkpoint. Checks: the
    library's parts are its plain version's, the layout cache holds one
    layout a part topology (parts of one topology share a layout) and one
    for the full mesh, each group of wrappers in
    ``groups`` ({name: [wrappers]}) launches blocks x steps (+ validation)
    times, finite losses within LATER_LOSS_RTOL of the plain path's,
    predict's RMSE validate's, and the rollout's first frame written with
    utils/vtu.py reads back to the same arrays. Returns ({wrapper name:
    (forward, backward)}, facts)."""
    import numpy as np
    import torch
    from graph_physics_tpu_torch import native
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.models.layers import lecun_parameters
    from graph_physics_tpu_torch.training import config as config_lib
    from graph_physics_tpu_torch.training.trainer import Trainer, TrainerConfig
    from graph_physics_tpu_torch.utils import vtu

    wrappers = [k for ks in groups.values() for k in ks]

    def trainer(name, kernels):
        sim = config_lib.get_simulator(param, config_lib.get_model(param, dtype=torch.bfloat16))
        lecun_parameters(sim, torch.Generator().manual_seed(0))
        cfg = TrainerConfig(epochs=1, batch_size=batch, learning_rate=1e-3, warmup=100,
                            log_every=1, packed=True, fused=True,
                            out_dir=str(ROOT / "build" / "fit"), run_name=name, seed=0,
                            previous_data_slice=prev)
        shutil.rmtree(ROOT / "build" / "fit" / name, ignore_errors=True)
        tr = Trainer(sim, train_ds, val_ds, loss_fn, cfg, gradient_method=gradient_method,
                     noise_cfg=config_lib.get_noise_config(param), device=device)
        if not kernels:  # the same layouts and batches, every block on the plain path
            tr._use_layout = lambda graph: None
        return tr

    # the parts: the library's against its plain version's
    pos, _, _ = train_ds._mesh(0)
    parts, subs = train_ds._partitions.parts_for(0, *train_ds._mesh(0)[::2])
    # parts of one topology (mirror images on a symmetric grid) share a layout
    topologies = len({sub.tobytes() for sub, _ in subs})
    lib = native.rcb_labels(pos, len(parts))
    same_parts = bool(np.array_equal(lib, native.rcb_labels_plain(pos, len(parts))))
    sizes = [len(p) for p in parts]

    # both fits in PyTorch's default mode: the plain path's sums add in a
    # fixed order (ops/segment.py), so the comparison repeats run to run
    tr = trainer(run, kernels=True)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {k.__name__: launch_counts(k) for k in wrappers}
    steps, n_blocks = tr.state.step, len(tr.sim.model.processor_list)
    records = epoch_records(tr)
    layouts = [(key, type(lay).__name__, lay.num_nodes, lay.total_rows)
               for key, lay in tr._fused_mgr._tilings.items()]
    want = (n_blocks * (steps + VAL_STEPS), n_blocks * steps)
    got = {g: tuple(map(sum, zip(*(fit_launches[k.__name__] for k in ks))))
           for g, ks in groups.items()}
    kl = step_losses(tr)
    log(f"{label}: {len(parts)} parts of {sizes} nodes, {topologies} topologies (library = "
        f"plain version: {same_parts}), {n_blocks} blocks, hidden {tr.sim.model.hidden_size}, B={batch}, "
        f"{steps} steps, validation {VAL_STEPS} rollout steps on the full mesh of "
        f"{int(val_ds.get_frame(0, val_ds._start, train=False).n_node)} nodes: {fit_s:.1f} s "
        f"({card})")
    for key, kind, nodes, rows in layouts:
        log(f"  layout {key[:2]}: {kind}, {nodes} nodes, {rows} rows")
    log(f"  launches (forward, backward): {fit_launches}; by group {got}, expected {want} each")
    log("  loss, kernel path: " + " ".join(f"{v:.6g}" for v in kl))
    values = kl + [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (not same_parts or len(layouts) != topologies + 1 or len(kl) != steps
            or not all(math.isfinite(v) for v in values)
            or any(v != want for v in got.values())):
        raise AssertionError(f"{label}: parts equal {same_parts}, {len(layouts)} layouts for "
                             f"{topologies} part topologies, {steps} steps, launches {got} (want {want}), "
                             f"losses {values}")

    # the plain path on the same batches
    plain = trainer(run + "_plain", kernels=False)
    reset_counts(wrappers)
    plain.fit()
    torch.cuda.synchronize()
    plain_launches = {k.__name__: launch_counts(k) for k in wrappers}
    pl = step_losses(plain)
    rel = [abs(a - b) / abs(b) for a, b in zip(kl, pl)]
    val_k = records[-1]["val_all_rollout_rmse"]
    val_p = epoch_records(plain)[-1]["val_all_rollout_rmse"]
    log("  loss, plain path:  " + " ".join(f"{v:.6g}" for v in pl))
    log(f"  loss relative difference max {max(rel):.6g} (limit {LATER_LOSS_RTOL}); validation "
        f"rmse kernel path {val_k:.8g}, plain path {val_p:.8g} (limit {ROLLOUT_RTOL}); plain "
        f"path launches {plain_launches}")
    if (len(pl) != len(kl) or max(rel) > LATER_LOSS_RTOL
            or abs(val_k - val_p) > ROLLOUT_RTOL * val_p
            or any(v != (0, 0) for v in plain_launches.values())):
        raise AssertionError(f"{label}: the kernel path is off the plain path's, or the plain "
                             "path launched a kernel")

    # predict from the checkpoint, as cli.predict --bf16 --fused runs it
    cfg_path = Path(tr.cfg.out_dir) / run / "config.json"
    cfg_path.write_text(json.dumps(param))
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
        "--fused", "--device", str(device), *predict_flags])
    reset_counts(wrappers)
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {k.__name__: launch_counts(k) for k in wrappers}
    got_p = {g: tuple(map(sum, zip(*(predict_launches[k.__name__] for k in ks))))
             for g, ks in groups.items()}
    want_p = (n_blocks * VAL_STEPS, 0)
    prel = abs(pred.rmse_all_rollout - val_k) / val_k
    log(f"  predict: launches by group {got_p}, expected {want_p} each; rmse_all_rollout "
        f"{pred.rmse_all_rollout:.8g}, validate reported {val_k:.8g} (relative difference "
        f"{prel:.3g}, limit {PREDICT_RTOL})")
    if prel > PREDICT_RTOL or any(v != want_p for v in got_p.values()):
        raise AssertionError(f"{label}: predict's rollout is not validate's, or its launches "
                             f"{got_p} are not {want_p}")

    # the rollout's first frame through utils/vtu.py and back
    g = val_ds.get_frame(0, val_ds._start, train=False)
    n = int(g.n_node)
    path = vtu.graph_to_vtu(str(ROOT / "build" / "fit" / run / "frame0.vtu"), g,
                            {"prediction": pred.predictions[0][:n]})
    vpos, vcells, vdata = vtu.read_vtu(path)
    c = int(np.sum(g.face_mask))
    d = g.pos.shape[1]
    same_vtu = (np.array_equal(vpos[:, :d], np.asarray(g.pos[:n], np.float64))
                and not vpos[:, d:].any() and np.array_equal(vcells, g.faces[:c])
                and np.array_equal(vdata["prediction"], pred.predictions[0][:n])
                and all(np.array_equal(vdata[f"x{i}"], g.x[:n, i]) for i in range(g.x.shape[1]))
                and all(np.array_equal(vdata[f"y{i}"], g.y[:n, i]) for i in range(g.y.shape[1])))
    log(f"  rollout frame 0 as VTU ({n} points, {c} cells, {len(vdata)} fields) reads back to "
        f"the same arrays: {same_vtu}")
    if not same_vtu:
        raise AssertionError(f"{label}: the VTU file does not read back to its arrays")

    # one step's time on a part's batch, kernel path and plain path
    batch_dev = next(iter(tr._loader(0)))
    gen = torch.Generator(device=device).manual_seed(5)
    step_ms = interval_ms(lambda: tr.train_step(tr.state, batch_dev, gen), 12)
    plain_ms = interval_ms(lambda: plain.train_step(plain.state, batch_dev, gen), 12)
    log(f"  train step B={batch} on a part ({int(batch_dev.n_node)} nodes): kernel path "
        f"{step_ms:.4f} ms, plain path {plain_ms:.4f} ms ({card})")
    facts = {"parts": sizes, "topologies": topologies, "layouts": [list(x[1:]) for x in layouts], "steps": steps,
             "fit_s": fit_s, "loss_rel_max": max(rel), "validate_rmse": val_k,
             "plain_validate_rmse": val_p, "predict_rmse": pred.rmse_all_rollout,
             "step_ms": step_ms, "plain_step_ms": plain_ms}
    del tr, plain, stack, batch_dev
    torch.cuda.empty_cache()
    return merge_launches(fit_launches, predict_launches), facts


def merge_launches(*parts):
    """{wrapper name: (forward, backward)} launches summed over ``parts``."""
    launches = defaultdict(lambda: [0, 0])
    for part in parts:
        for name, (f, b) in part.items():
            launches[name][0] += f
            launches[name][1] += b
    return {k: tuple(v) for k, v in launches.items()}


def submesh_epd_phase(device, card):
    """Phase 44: training_config/cylinder.json's model (hidden 32, 5 blocks,
    bf16, packed, fused) through Trainer.fit on the sub-meshes of a
    SUBMESH_MESH cylinder grid, once for each of SUBMESH_RUNS, validation on
    the full mesh (submesh_fit's checks), the host mesh library against its
    plain versions on this mesh, and the loader's host time with and
    without partitions. Returns ({wrapper name: (forward, backward)}, facts)."""
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training.loss import l2_loss

    ds = memory_dataset_class()
    fc = FrameConfig(targets=("velocity",))
    traj = synthetic.make_trajectory(*SUBMESH_MESH, SUBMESH_FRAMES)
    meta = synthetic.meta_dict(SUBMESH_FRAMES)
    val_ds = ds([synthetic.make_trajectory(*SUBMESH_MESH, VAL_STEPS + 1)],
                synthetic.meta_dict(VAL_STEPS + 1), fc)
    param = cylinder_param()
    groups = {"rows 1-4": [nk_ops.fused_gn_block_nk, csr_ops.fused_gn_block_csr]}
    facts = {"library_ms": library_checks("phase 44", traj)}
    runs = []
    for i, parts in enumerate(SUBMESH_RUNS):
        launches, f = submesh_fit(f"phase 44 [{parts}]", param, ds([traj], meta, fc, **parts),
                                  val_ds, device, card, SUBMESH_BATCH, f"fit_submesh_{i}",
                                  groups, l2_loss)
        runs.append(launches)
        facts[json.dumps(parts)] = f
    facts["loader"] = loader_times(
        "phase 44", lambda p: ds([traj], meta, fc, **(SUBMESH_RUNS[0] if p else {})),
        SUBMESH_BATCH, "epd")
    return merge_launches(*runs), facts


def submesh_transformer_phase(device, card):
    """Phase 45: training_config/coarse-aneurysm.json (10 blocks, hidden 64,
    4 heads, ``--external aneurysm``, ``--use_previous_data`` on
    entry.aneurysm_previous_data's columns) through Trainer.fit on the
    sub-meshes (at most ANEURYSM_PART_NODES nodes) of phase 42's
    ANEURYSM_MESH, validation on the full mesh, with submesh_fit's checks
    for rows 5/6 (7/8 where a part takes CSR) and 9/10. Returns ({wrapper
    name: (forward, backward)}, facts)."""
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.dataset import synthetic
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.training import config as config_lib

    ds = memory_dataset_class()
    param = entry.aneurysm_param("coarse")
    frame_cfg = entry.aneurysm_frame_config("coarse")
    fields = entry.aneurysm_fields(*ANEURYSM_MESH, ANEURYSM_FIT_FRAMES)
    prev = entry.aneurysm_previous_data(fields)
    meta = synthetic.xdmf_meta_dict(ANEURYSM_FIT_FRAMES, entry.ANEURYSM_DT)
    parts = {"max_nodes_per_partition": ANEURYSM_PART_NODES}
    val_ds = ds([entry.aneurysm_fields(*ANEURYSM_MESH, VAL_STEPS + 2)],
                synthetic.xdmf_meta_dict(VAL_STEPS + 2, entry.ANEURYSM_DT), frame_cfg)
    groups = {"attention": [ea_nk.fused_edge_attention_nk, ea_csr.fused_edge_attention_csr],
              "ffn": [ffn_ops.fused_gated_ffn]}
    loss_fn, _ = config_lib.get_loss(param)
    facts = {"library_ms": library_checks("phase 45", fields)}
    launches, facts["fit"] = submesh_fit(
        f"phase 45 [{parts}]", param, ds([fields], meta, frame_cfg, **parts), val_ds, device,
        card, TF_FIT_BATCH, "fit_submesh_aneurysm", groups, loss_fn,
        gradient_method=config_lib.get_gradient_method(param), prev=prev,
        predict_flags=("--external", "aneurysm", "--use_previous_data", "--previous_data_start",
                       str(prev[0]), "--previous_data_end", str(prev[1])))
    facts["loader"] = loader_times(
        "phase 45", lambda p: ds([fields], meta, frame_cfg, **(parts if p else {})),
        TF_FIT_BATCH, "transformer")
    return launches, facts


def submesh_phases(device, card):
    """Phases 44-45; returns {wrapper name: (forward, backward) launches}."""
    epd_launches, epd = submesh_epd_phase(device, card)
    log("sub-mesh epd " + json.dumps({"card": card, **epd}))
    tf_launches, tf = submesh_transformer_phase(device, card)
    log("sub-mesh transformer " + json.dumps({"card": card, **tf}))
    return merge_launches(epd_launches, tf_launches)


# ---- phases 46-48: rows 5-10 at every width JAX fuses ----

#: the transformer widths whose kernel instances are new: (hidden, heads),
#: each one FFN width (rows 9/10) and one head width (rows 5-8); hidden 32
#: with 4 heads (head width 8) is the main path of phases 47-48
SMALL_CONFIGS = ((32, 4), (16, 4), (8, 4), (4, 4), (2, 2), (1, 1), (128, 2), (128, 1))
SMALL_MAIN = (32, 4)
#: the head widths of phase 46's world-seam checks
SMALL_WORLD_DH = (8, 64)
#: phase 46's sweep of each width on its path: blocks and batch of the
#: cylinder (NK) models; nodes and batch of the graded (CSR) ones
SWEEP_BLOCKS, SWEEP_BATCH, SWEEP_GRADED = 2, 16, (4000, 4)
#: phase 48: trajectories of the fit (FIT_FRAMES frames, B=TF_FIT_BATCH), epochs
SMALL_FIT_TRAJECTORIES, SMALL_FIT_EPOCHS = 2, 1


def small_record(kind, layout, width, backward):
    """A new instance's record: its name, source and the TPU kernel it
    replaces."""
    if kind == "ffn":
        name = f"fused_gated_ffn_h{width}"
        src, line = "fused_ffn_small" + ("_bwd" if backward else ""), 99 if backward else 74
        rec = {"source": f"graph_physics_tpu_torch/csrc/{src}.cu",
               "replaces": f"graph_physics_tpu/ops/fused_ffn.py:{line}"}
    else:
        name = f"fused_edge_attention_{layout}_dh{width}"
        base = ATTN_BWD if backward else ATTN
        if layout == "csr":
            base = ATTN_CSR_BWD if backward else ATTN_CSR
        rec = {k: base[k] for k in ("source", "replaces")}
    return {"name": name + ("_backward" if backward else ""), **rec}


def sdpa_ms(qkv, rows, n, backward, cot=None, efficient_only=False):
    """The library's yardstick: one masked scaled_dot_product_attention over
    the mesh's adjacency (dense, rows: receivers) on the same q, k, v, its
    forward or forward + backward, by CUDA events; with
    ``efficient_only`` on the memory-efficient kernel alone, None where
    that kernel does not take the head width (a multiple of 8), the
    median of 5 calls (one takes 45-400 ms on the graded mesh)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dh = qkv[0].shape[-1]
    if efficient_only and dh % 8:
        return None
    senders, receivers, mask = rows
    adj = torch.zeros((n, n), dtype=torch.bool, device=qkv[0].device)
    adj[receivers[mask].long(), senders[mask].long()] = True
    dense = [t.permute(1, 2, 0, 3).contiguous() for t in qkv]
    kw = dict(warmup=1, reps=5) if efficient_only else {}
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]) if efficient_only else \
            contextlib.nullcontext():
        if not backward:
            with torch.inference_mode():
                return cuda_ms(lambda: F.scaled_dot_product_attention(*dense, attn_mask=adj),
                               **kw)
        leaves = [t.requires_grad_(True) for t in dense]
        cot_d = cot.permute(1, 2, 0, 3).contiguous()
        return cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, attn_mask=adj), leaves, cot_d), **kw)


def small_ffn_checks(h, n, b, gen, device):
    """Phase 46 for rows 9/10 at hidden ``h`` on [n, b, h] rows (block
    weights drawn from ``gen``): the forward against its plain version,
    the backward against its plain backward and fp32 autograd, each the
    same bits on two calls. Returns (record fields by backward, the calls
    for the device-time sweeps: forward, backward)."""
    import torch
    from graph_physics_tpu_torch.models.layers import GatedMLPBlock, RMSNorm, reset_parameters
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
    from graph_physics_tpu_torch.utils import gradcheck

    ffn = ffn_ops.fused_gated_ffn
    mlp, norm2 = GatedMLPBlock(h, h, h), RMSNorm(h)
    reset_parameters(mlp, gen)
    with torch.no_grad():
        for norm in (mlp.norm, norm2):
            norm.scale.copy_(1.0 + 0.2 * torch.randn(h, generator=gen))
    mlp, norm2 = mlp.to(device), norm2.to(device)
    x, cot = (torch.randn((n, b, h), generator=gen).to(device, torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        before = ffn.launches
        y1, y2 = ffn(x, mlp, norm2), ffn(x, mlp, norm2)
        torch.cuda.synchronize()
        log(f"hidden-{h} FFN forward kernel check [{n}·{b} rows]")
        if ffn.launches != before + 2 or not torch.equal(y1, y2):
            raise AssertionError(f"hidden-{h} FFN forward: no launch, or other bits on a "
                                 "second call")
        f_err = compare("y", y1, ffn_ops.gated_ffn_reference(x, mlp, norm2), FFN_TOL)

    def feed_forward(fn, m, n2):
        return lambda xx: (fn(xx, m, n2), ffn_ops._params(m, n2))

    names = ["dx", "norm2.scale", "norm.scale", "W1", "b1", "W2", "b2", "W3", "b3"]
    before = ffn.backward_launches
    rows, ok, kept = gradcheck.check_backward(
        names, ("dx",), feed_forward(ffn, mlp, norm2),
        feed_forward(ffn_ops.reference_with_backward, mlp, norm2),
        feed_forward(ffn_ops.gated_ffn_reference, gradcheck.rounded_copy(mlp),
                     gradcheck.rounded_copy(norm2)), [x], [cot])
    torch.cuda.synchronize()
    log(f"hidden-{h} FFN backward kernel check (against the plain backward; both against fp32)")
    log_grad_rows(rows)
    g1, g2 = (torch.autograd.grad(*kept["kernel"], retain_graph=True) for _ in range(2))
    if ffn.backward_launches != before + 3 or not ok or not all(
            torch.equal(a, c) for a, c in zip(g1, g2)):
        raise AssertionError(f"hidden-{h} FFN backward kernel out of bounds, not launched or "
                             "other bits on a second call")
    log("  the same bits on two calls, forward and backward")

    def forward(fn):
        def run():
            with torch.inference_mode():
                fn(x, mlp, norm2)
        return run

    params = sum(p.numel() for p in ffn_ops._params(mlp, norm2))
    prods = 2 * n * b * h * 3 * h
    fields = {
        False: dict(max_abs_err=f_err, ms=cuda_ms(forward(ffn)),
                    plain_ms=cuda_ms(forward(ffn_ops.gated_ffn_reference)), library_ms=None,
                    bound=bound(2 * 2 * x.numel() + 4 * params, 3 * prods)),
        True: dict(max_abs_err=max(r.get("max_abs_err", float("inf")) for r in rows),
                   ms=cuda_ms(lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True)),
                   plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept["plain"],
                                                                 retain_graph=True)),
                   library_ms=None, bound=bound(2 * 3 * x.numel() + 8 * params, 8 * prods)),
    }
    return fields, (forward(ffn), lambda: torch.autograd.grad(*kept["kernel"],
                                                               retain_graph=True))


def small_attention_checks(label, ops, graph, layout, heads, dh, gen, sdpa_efficient):
    """Phase 46 for rows 5/6 (NK) or 7/8 (CSR) at head width ``dh``: the
    forward against its plain version with receivers whose rows are all
    masked (exact zeros), its kept statistics, the same bits on two calls;
    the backward against its plain backward and fp32 autograd
    (utils/gradcheck.py), dq exactly 0 on those receivers, the same bits
    on two calls. Returns (record fields by backward, the calls for the
    device-time sweeps: forward, backward)."""
    import torch
    from graph_physics_tpu_torch.utils import gradcheck

    name = ops.__name__.rsplit(".", 1)[-1]
    op = getattr(ops, name)
    n, b = graph.x.shape[:2]
    device = graph.x.device

    def randn(scale):
        return (torch.randn((n, b, heads, dh), generator=gen, device=device) * scale).to(
            torch.bfloat16)

    q, k, v, cot = randn(0.5), randn(0.5), randn(0.5), randn(1.0)
    gone = torch.arange(0, int(graph.node_mask.sum()), EMPTY_STRIDE, device=device)
    mask = graph.edge_mask & ~torch.isin(graph.receivers, gone)
    rows = (graph.senders, graph.receivers, mask)
    with torch.inference_mode():
        before = op.launches
        out, again = op(q, k, v, *rows, layout), op(q, k, v, *rows, layout)
        torch.cuda.synchronize()
        log(f"{label} kernel check ({n} nodes x {b} samples x {heads} heads of {dh}, "
            f"{len(gone)} receivers without a valid row)")
        if op.launches != before + 2 or not torch.equal(out, again):
            raise AssertionError(f"{label}: no launch, or other bits on a second call")
        f_err = compare("out", out, ops.PLAIN[0](q, k, v, *rows, layout), ATTN_RTOL,
                        atol=ATTN_ATOL)
        if not torch.equal(out[gone], torch.zeros_like(out[gone])):
            raise AssertionError(f"{label}: a receiver without valid rows is not exactly 0")
        check_kept_stats(label, ops.KERNELS, (q, k, v), rows, layout, out)

    def attention(fn):
        return lambda *t: (fn(*t, *rows, layout), [])

    grad_names = ("dq", "dk", "dv")
    before = op.backward_launches
    grad_rows, ok, kept = gradcheck.check_backward(
        grad_names, grad_names, attention(op), attention(ops.reference_with_backward),
        attention(ops.PLAIN[0]), [q, k, v], [cot])
    torch.cuda.synchronize()
    log(f"{label} backward kernel check (against the plain backward; both against fp32)")
    log_grad_rows(grad_rows)
    g1, g2 = (torch.autograd.grad(*kept["kernel"], retain_graph=True) for _ in range(2))
    if op.backward_launches != before + 3 or not ok or not all(
            torch.equal(a, c) for a, c in zip(g1, g2)):
        raise AssertionError(f"{label}: backward kernel out of bounds, not launched or other "
                             "bits on a second call")
    if not torch.equal(g1[0][gone], torch.zeros_like(g1[0][gone])):
        raise AssertionError(f"{label}: dq is not exactly 0 where a receiver has no valid row")
    log("  the same bits on two calls, forward and backward; dq exactly 0 without valid rows")

    def forward(fn):
        def run():
            with torch.inference_mode():
                fn(q, k, v, *rows, layout)
        return run

    valid = int(mask.sum())
    fields = {
        False: dict(max_abs_err=f_err, ms=cuda_ms(forward(op)),
                    plain_ms=cuda_ms(forward(ops.PLAIN[0])),
                    library_ms=sdpa_ms((q, k, v), rows, n, False,
                                       efficient_only=sdpa_efficient),
                    bound=bound(2 * 4 * q.numel() + 5 * mask.numel(), valid * b * heads * 4 * dh)),
        True: dict(max_abs_err=max(r.get("max_abs_err", float("inf")) for r in grad_rows),
                   ms=cuda_ms(lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True)),
                   plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept["plain"],
                                                                 retain_graph=True)),
                   library_ms=sdpa_ms((q, k, v), rows, n, True, cot,
                                      efficient_only=sdpa_efficient),
                   bound=bound(2 * 7 * q.numel() + 5 * mask.numel(),
                               valid * b * heads * 10 * dh)),
    }
    return fields, (forward(op), lambda: torch.autograd.grad(*kept["kernel"],
                                                              retain_graph=True))


def sweep_device_ms(label, calls):
    """{record name: device ms per call} of each call in ``calls`` ({record
    name: fn}), from one profiler sweep that runs them all in turn: each
    record takes the kernels of its instance (``instance_kernels``); a
    record none of whose kernels the profiler recorded takes its call's
    ``queued_device_ms``."""
    times = device_times(lambda: [fn() for fn in calls.values()])
    out = {}
    for key, fn in calls.items():
        mine = [k for k in times if any(is_kernel(k, fam, w) for fam, w in instance_kernels(key))]
        if mine:
            out[key] = sum(times[k] for k in mine)
        else:
            out[key] = queued_device_ms(fn, 20)
            log(f"  {label}: the profiler recorded no kernel of {key}; by CUDA events "
                f"queued behind a sleep: {out[key]:.4f} ms a call")
    return out


def is_kernel(name, family, width):
    """Whether a CUDA kernel's name, mangled (ptxas) or demangled (the
    profiler), is the template ``family`` at its first argument ``width``."""
    return any(f"{family}{tail}" in name for tail in (f"ILi{width}E", f"<{width}>", f"<{width},"))


def small_kernel_phase(device, card, build_log):
    """Phase 46: every new instance of rows 5-10 against its plain version
    (small_ffn_checks, small_attention_checks; the world seam at
    SMALL_WORLD_DH in both layouts, world_kernel_check), at the cylinder
    transformer's shape (1,920 nodes x 64 samples, NK) and the graded
    mesh's (27,008 x 16, CSR), with ptxas's registers and spills, times,
    bounds and the library's masked attention. Returns {record name:
    fields}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk

    resources = kernel_resources(build_log, ("ffn_small", "ea_nk_", "ea_csr_"))
    for name, use in resources.items():
        log(f"ptxas, rows 5-10 instance {name}: {use}")
    cyl = entry.transformer_setup(device, mp_steps=1)
    graded = entry.graded_transformer_setup(device, mp_steps=1)
    gen = torch.Generator().manual_seed(46)
    cgen = torch.Generator(device=device).manual_seed(46)
    fields, calls = {}, {}
    n, b = cyl.graph.x.shape[:2]
    head_dims = set()
    for h, heads in SMALL_CONFIGS:
        if h < 64:
            f, c = small_ffn_checks(h, n, b, gen, device)
            for bw in (False, True):
                key = small_record("ffn", None, h, bw)["name"]
                fields[key], calls[key] = f[bw], c[bw]
        dh = h // heads
        if dh in head_dims:  # head width 1 serves hidden 4, 2 and 1
            continue
        head_dims.add(dh)
        for layout, ops, setup in (("nk", ea_nk, cyl), ("csr", ea_csr, graded)):
            label = f"{'NK' if layout == 'nk' else 'CSR'} attention at head width {dh}"
            f, c = small_attention_checks(label, ops, setup.graph, setup.tiling, heads, dh, cgen,
                                          sdpa_efficient=layout == "csr")
            for bw in (False, True):
                key = small_record("attention", layout, dh, bw)["name"]
                fields[key], calls[key] = f[bw], c[bw]
            if dh in SMALL_WORLD_DH:
                g, lay = setup.graph, setup.tiling
                nv = int(g.node_mask.sum())
                gone = torch.arange(0, nv, EMPTY_STRIDE, device=device)
                mask = g.edge_mask & ~torch.isin(g.receivers, gone)
                qkv = [(torch.randn((lay.num_nodes, g.x.shape[1], heads, dh), generator=cgen,
                                    device=device) * 0.5).to(torch.bfloat16) for _ in range(3)]
                cot = torch.randn(qkv[0].shape, generator=cgen, device=device).to(torch.bfloat16)
                sidecar = synthetic_sidecar(nv, lay.num_nodes, g.x.shape[1], WORLD_SLOTS,
                                            gone, cgen, device)
                err, bwd_err, _ = world_kernel_check(
                    f"{label}", ops, qkv, (g.senders, g.receivers, mask), lay, sidecar, cot,
                    card, (), (), timing=False)
                for bw, e in ((False, err), (True, bwd_err)):
                    key = small_record("attention", layout, dh, bw)["name"]
                    fields[key]["max_abs_err"] = max(fields[key]["max_abs_err"], e)
                    fields[key]["world_checked"] = True
    for bw in (False, True):  # the device time of every instance, one sweep a direction
        keys = [k for k in calls if k.endswith("_backward") == bw]
        for key, ms in sweep_device_ms("phase 46", {k: calls[k] for k in keys}).items():
            fields[key]["device_ms"] = ms
    for key, f in fields.items():
        f["bound_ms"], f["bound_by"] = f.pop("bound")
        f["ptxas"] = {k: v for k, v in resources.items()
                      if any(is_kernel(k, fam, w) for fam, w in instance_kernels(key))}
        lib = f["library_ms"]
        log(f"  {key}: kernel {f['ms']:.4f} ms (device {f['device_ms']:.4f}), plain "
            f"{f['plain_ms']:.4f} ms, library "
            + (f"{lib:.4f} ms" if lib is not None else "none") +
            f", bound {f['bound_ms']:.6g} ms ({f['bound_by']}) ({card})")
    del cyl, graded, calls
    torch.cuda.empty_cache()
    return fields


def instance_kernels(key):
    """(template, width) of each CUDA kernel of a phase-46 record: the FFN's
    ``ffn_small_{fwd,bwd,bwd_sum}_kernel<H>``, the attention's
    ``ea_{nk,csr}_{fwd,bwd_recv,bwd_send}_kernel<DH, ...>``."""
    backward = key.endswith("_backward")
    if key.startswith("fused_gated_ffn"):
        width = int(key.split("_h")[1].split("_")[0])
        kinds = ("bwd", "bwd_sum") if backward else ("fwd",)
        return [(f"ffn_small_{k}_kernel", width) for k in kinds]
    width = int(key.split("_dh")[1].split("_")[0])
    layout = "nk" if "_nk_" in key else "csr"
    kinds = ("bwd_recv", "bwd_send") if backward else ("fwd",)
    return [(f"ea_{layout}_{k}_kernel", width) for k in kinds]


def small_sweep_phase(device, card):
    """Phase 47: each width of SMALL_CONFIGS on its path, counts set to 0
    just before: a SWEEP_BLOCKS-block model's eval forward and one train
    step on the cylinder (NK, B=SWEEP_BATCH) and on a SWEEP_GRADED graded
    mesh (CSR), each against the plain path (forward TF_SLICE_TOL, step-1
    loss STEP1_LOSS_RTOL), every block launching its attention and FFN
    kernels once forward and once backward (the FFN at hidden 128 on the
    hidden-128 instance). Returns {record name: launches}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_csr
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops

    ffn = ffn_ops.fused_gated_ffn
    launches = defaultdict(int)
    for h, heads in SMALL_CONFIGS:
        dh = h // heads
        for layout, attn in (("nk", ea_nk.fused_edge_attention_nk),
                             ("csr", ea_csr.fused_edge_attention_csr)):
            if layout == "nk":
                train = entry.transformer_train_setup(device, hidden=h, heads=heads,
                                                      mp_steps=SWEEP_BLOCKS, batch=SWEEP_BATCH)
            else:
                train = entry.graded_transformer_train_setup(
                    device, num_nodes=SWEEP_GRADED[0], batch=SWEEP_GRADED[1], hidden=h,
                    heads=heads, mp_steps=SWEEP_BLOCKS)
            sim, graph = train.simulator, train.graph
            plain_sim = plain_copy(sim)
            plain_state, plain_step = entry.make_trainer(plain_sim)
            reset_counts([attn, ffn])
            out = sim.forward(graph, is_training=False)
            m = train.train_step(train.state, graph, torch.Generator(device).manual_seed(47))
            torch.cuda.synchronize()
            got = {k.__name__: launch_counts(k) for k in (attn, ffn)}
            ref = plain_sim.forward(graph, is_training=False)
            mp = plain_step(plain_state, graph, torch.Generator(device).manual_seed(47))
            rel = abs(m["loss"].item() - mp["loss"].item()) / abs(mp["loss"].item())
            want = (2 * SWEEP_BLOCKS, SWEEP_BLOCKS)
            log(f"phase 47 [hidden {h}, {heads} heads of {dh}, {type(train.tiling).__name__}, "
                f"{graph.x.shape[0]} nodes x {graph.x.shape[1]}]: launches (forward, backward) "
                + ", ".join(f"{k} {v}" for k, v in got.items())
                + f", expected {want} each; step-1 loss {m['loss'].item():.6g} against the "
                f"plain path's {mp['loss'].item():.6g} (relative {rel:.3g}, limit "
                f"{STEP1_LOSS_RTOL})")
            compare("net_out", out.net_out, ref.net_out, TF_SLICE_TOL, rows=graph.node_mask)
            if any(v != want for v in got.values()) or rel > STEP1_LOSS_RTOL or not (
                    torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise AssertionError(f"phase 47 [hidden {h}, {layout}]: launches {got} or the "
                                     "loss off the plain path's")
            for key, (f, bwd) in ((small_record("attention", layout, dh, False)["name"],
                                   got[attn.__name__]),
                                  (f"fused_gated_ffn_h{h}", got[ffn.__name__])):
                launches[key] += f
                launches[f"{key}_backward"] += bwd
            del train, sim, plain_sim, plain_state, plain_step
    torch.cuda.empty_cache()
    return dict(launches)


def small_main_phase(device, card):
    """Phase 48, the main path of phases 46-48: the graph transformer at
    hidden 32 with 4 heads (head width 8; entry.transformer_train_setup:
    10 blocks, B=64, the cylinder mesh, NK): 20 train steps against the
    plain path (training_phase), the step's wall, device and enqueue time;
    then the model through Trainer.fit (SMALL_FIT_TRAJECTORIES
    trajectories, B=TF_FIT_BATCH, SMALL_FIT_EPOCHS epoch, a VAL_STEPS-step
    validation rollout) and predict from its checkpoint: launches held to
    the prediction, predict's RMSE validate's. Returns ({record name:
    launches}, facts)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_nk
    from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops

    attn, ffn = ea_nk.fused_edge_attention_nk, ffn_ops.fused_gated_ffn
    h, heads = SMALL_MAIN
    dh = h // heads
    train = entry.transformer_train_setup(device, hidden=h, heads=heads)
    n_blocks = len(train.simulator.model.processor_list)
    _, plain_state, plain_step, step_launches = training_phase(
        f"hidden-{h} transformer training", train, [attn, ffn], 48)
    st = step_timing(train, plain_state, plain_step, 49)
    b = train.graph.x.shape[1]
    idle = 1.0 - st["train_step_device_ms"] / st["train_step_ms"]
    log(f"hidden-{h} transformer train step B={b}: {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms, idle share {idle:.3f}; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms), plain path {st['train_step_plain_ms']:.4f} "
        f"ms ({card})")
    del train, plain_state, plain_step
    torch.cuda.empty_cache()

    param = cylinder_param()
    param["model"] = {"type": "transformer", "message_passing_num": n_blocks, "hidden_size": h,
                      "num_heads": heads, "node_input_size": 2, "output_size": 2,
                      "edge_input_size": 0}
    train_ds, val_ds = fit_datasets(SMALL_FIT_TRAJECTORIES)
    tr = fit_trainer(param, train_ds, val_ds, "fit_small", device, batch=TF_FIT_BATCH,
                     epochs=SMALL_FIT_EPOCHS)
    reset_counts([attn, ffn])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    steps, records = tr.state.step, epoch_records(tr)
    log(f"fit, the hidden-{h} transformer ({n_blocks} blocks, {heads} heads of {dh}, bf16, "
        f"{type(tr.sim.model.tiling).__name__} layout; {SMALL_FIT_TRAJECTORIES} trajectories of "
        f"{FIT_FRAMES} frames, B={TF_FIT_BATCH}, {SMALL_FIT_EPOCHS} epoch, {steps} steps, "
        f"validation {VAL_STEPS} rollout steps): {fit_s:.1f} s ({card})")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    want = (n_blocks * (steps + SMALL_FIT_EPOCHS * VAL_STEPS), n_blocks * steps)
    log("  launches (forward, backward): " + ", ".join(
        f"{k} {v}" for k, v in fit_launches.items()) + f"; expected {want} each")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(records) != SMALL_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or any(v != want for v in fit_launches.values())):
        raise AssertionError(f"phase 48: {steps} steps, launches {fit_launches}, records "
                             f"{records}")
    cfg_path = Path(tr.cfg.out_dir) / tr.cfg.run_name / "cylinder_transformer_h32.json"
    cfg_path.write_text(json.dumps(param))
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
        "--fused", "--device", str(device)])
    reset_counts([attn, ffn])
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {k.__name__: launch_counts(k) for k in (attn, ffn)}
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, the hidden-{h} transformer: checkpoint step {stack.step}, rollout of "
        f"{pred.predictions.shape[0]} steps, launches (forward, backward) "
        + ", ".join(f"{k} {v}" for k, v in predict_launches.items()) + f", expected {want} "
        f"each: rmse_all_rollout {pred.rmse_all_rollout:.8g}, validate reported "
        f"{want_rmse:.8g} (relative difference {rel:.3g}, limit {PREDICT_RTOL})")
    if (stack.step != steps or rel > PREDICT_RTOL
            or any(v != want for v in predict_launches.values())):
        raise AssertionError("phase 48: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    total = merge_launches(step_launches, fit_launches, predict_launches)
    attn_key = small_record("attention", "nk", dh, False)["name"]
    launches = {attn_key: total[attn.__name__][0], f"{attn_key}_backward": total[attn.__name__][1],
                f"fused_gated_ffn_h{h}": total[ffn.__name__][0],
                f"fused_gated_ffn_h{h}_backward": total[ffn.__name__][1]}
    facts = {"train_step": st, "idle_share": idle, "fit_s": fit_s,
             "predict_rmse": pred.rmse_all_rollout, "validate_rmse": want_rmse}
    return launches, facts


def earlier_widths_bits():
    """The attention kernels at head widths 16 and 32, the gated FFN (GELU)
    at every hidden width and rows 1-4 (relu) at hidden 32, 64 and 128
    against the earlier trees' bits: the digests of
    scripts/kernel_digests.py (loaded by its path: the card's machine has a
    site-packages module named ``scripts``) against its RECORDED ones for
    this card's SM count. Returns the cases held."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("kernel_digests",
                                                  ROOT / "scripts" / "kernel_digests.py")
    kd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kd)
    return kd.check(kd.digests(ROOT, DEVICE), kd.card_key())


def small_width_phases(device, card, build_log):
    """Phases 46-48: the new instances of rows 5-10 checked and timed
    (46), each width on its path (47), the hidden-32 transformer trained,
    fitted and predicted (48). Returns their records, with the launches of
    phase 47, or of phase 48 for the main path's instances (phase 47's
    under "sweep_launches"), and {record name: launches} of the older
    records (the hidden-128 FFN's) in phase 47."""
    held = earlier_widths_bits()
    log(f"the earlier widths' kernels give the parent tree's bits: {', '.join(held)}")
    fields = small_kernel_phase(device, card, build_log)
    launches = small_sweep_phase(device, card)
    main_launches, facts = small_main_phase(device, card)
    log("hidden-32 transformer " + json.dumps({"card": card, **facts}))
    if set(main_launches) - set(fields):
        raise AssertionError(f"phase 48: launches of no record: {main_launches}")
    records = []
    for key, f in fields.items():
        kind = "ffn" if key.startswith("fused_gated_ffn") else "attention"
        base = key[:-len("_backward")] if key.endswith("_backward") else key
        layout = None if kind == "ffn" else base.split("_")[3]
        width = int(base.rsplit("_h" if kind == "ffn" else "_dh", 1)[1])
        rec = dict(small_record(kind, layout, width, key.endswith("_backward")), route="cuda",
                   launches=launches.pop(key, 0), **f)
        if key in main_launches:  # the main path's own count; phase 47's beside it
            rec["sweep_launches"], rec["launches"] = rec["launches"], main_launches[key]
        if rec["launches"] == 0:
            raise AssertionError(f"phases 47-48: {key} never launched on its path")
        records.append(rec)
    return records, launches


# ---- phases 49-51: rows 1-4 at every width and activation JAX fuses; epd at hidden 16 ----

#: the widths of rows 1-4 under 32 (csrc/fused_gnblock_{nk,csr}*.cu built
#: once a width, the tiles zero-padded to 16 columns below 16)
GN_SMALL_HIDDEN = (16, 8, 4, 2, 1)
#: the activations besides relu that rows 1-4 take, and the widths phases
#: 49-50 hold them at: every width (the tile family's 1-32, the wide 64, 128)
GN_ACTS = ("silu", "gelu")
GN_ACT_HIDDEN = (1, 2, 4, 8, 16, 32, 64, 128)
#: phase 49: the widths whose world seam (extra_agg) is checked
GN_SEAM_SMALL = (16, 4)
#: phase 49's shapes, cut from the slices' (the cylinder at B=128, the
#: graded mesh's 27,008 x 16) so that the checks and times of the new
#: instances fit the run: the cylinder (NK) at B=GN_CHECK_BATCH, a graded
#: mesh (CSR) of GN_CHECK_GRADED (nodes, batch); phase 51 times the main
#: path's instance (hidden 16, NK) at B=128
GN_CHECK_BATCH, GN_CHECK_GRADED = 32, (8000, 8)
#: phase 49: CUDA-event medians of each instance over these calls
GN_TIME_REPS = 10
#: phase 50: each instance on its path: blocks and batch of the cylinder
#: (NK, GN_SWEEP_MESH) models, nodes and batch of the graded (CSR) ones
GN_SWEEP_BLOCKS, GN_SWEEP_BATCH, GN_SWEEP_MESH, GN_SWEEP_GRADED = 2, 8, (20, 16), (4000, 4)
#: phase 51, the main path: ``epd`` at hidden 16 (entry.cylinder_train_setup:
#: 5 blocks, B=128, NK, the encoder folded); its fit's trajectories and epochs
GN_MAIN_HIDDEN = 16
GN_FIT_TRAJECTORIES, GN_FIT_EPOCHS = 2, 1


def gn_instances():
    """(layout, hidden, activation) of every instance of rows 1-4 that
    phases 49-51 hold: relu at hidden 16 to 1, silu and gelu at
    GN_ACT_HIDDEN, in both layouts."""
    out = [(lay, h, "relu") for h in GN_SMALL_HIDDEN for lay in ("nk", "csr")]
    return out + [(lay, h, a) for a in GN_ACTS for h in GN_ACT_HIDDEN for lay in ("nk", "csr")]


def gn_instance_record(layout, h, act, backward):
    """The kernels-line keys of row 1-4 (``layout``, ``backward``) at hidden
    ``h`` with ``act`` MLPs: fused_gn_block_{layout}_h{h}[_{act}][_backward]."""
    rec = wide_record(layout, h, backward)
    if h not in WIDE_HIDDEN:
        rec["source"] = (f"graph_physics_tpu_torch/csrc/fused_gnblock_{layout}"
                         + ("_bwd" if backward else "") + ".cu")
    if act != "relu":
        rec["name"] = rec["name"].replace(f"_h{h}", f"_h{h}_{act}")
    return rec


def set_block_activation(model, act):
    """Every GraphNetBlock of ``model`` with ``act`` MLPs, in place (the
    parameters, and so a trainer's optimizer, stay; the encoders keep
    their activation, as in an ``epd``): what GraphNetBlock(activation=act)
    builds, for a model whose processors pass none, as in JAX."""
    from graph_physics_tpu_torch.models.layers import ACTIVATIONS, Activation

    for blk in model.processor_list:
        blk.activation = act
        for mlp in (blk.edge_block, blk.node_block):
            mlp.activation, mlp.act_fn = act, ACTIVATIONS[act]
            for i, m in enumerate(mlp):
                if isinstance(m, Activation):
                    mlp[i] = Activation(act)


def first_variant(h):
    """The first block's variant at hidden ``h``: the edge encoder folded
    where JAX folds it (raw features no wider than h // 2), else the first
    block on encoded edges."""
    from graph_physics_tpu_torch import entry

    return "folded" if entry.EDGE_INPUT <= h // 2 else "first"


def gn_instance_ptxas(resources, layout, h, act, backward):
    """The ptxas reports of one instance's kernels: its width's, its layout's
    (or both layouts' shared ones), its direction's, and of its activation
    (the ACTS instance: the last boolean template argument of a kernel
    that has one)."""
    import re

    out = {}
    for name, use in resources.items():
        if h in WIDE_HIDDEN:
            if f"gnw{h}_" not in name:
                continue
            m = re.search(r"gnw\d+_(\w+?)(?:I|E)", name)
            kind = m.group(1) if m else ""
            bwd = any(k in kind for k in ("bwd", "send", "wgrad", "wsum"))
        else:
            if f"ILi{h}E" not in name:
                continue
            kind = name
            bwd = "bwd" in name or "reduce" in name
        if bwd != backward and "partial" not in kind and "enc_fwd" not in kind:
            continue
        other = "csr" if layout == "nk" else "nk"
        if f"gn_{other}_" in name or f"gnw{h}_{other}_" in name:
            continue
        flags = re.findall(r"Lb(\d)E", name)
        acts_kernel = any(k in kind for k in ("fwd_kernel", "nodemlp", "row_kernel", "edge_fwd",
                                              "node_fwd", "node_bwd", "row_bwd", "enc_fwd",
                                              "enc_bwd"))
        if acts_kernel and flags and (flags[-1] == "1") != (act != "relu"):
            continue
        out[name] = use
    return out


def gn_times(fn, libs, profile):
    """gn_instance_check's times of ``fn``: CUDA events over GN_TIME_REPS
    calls, the profiler's device ms unless not ``profile`` (then None);
    with a parent tree and ``libs``, the parent's beside them."""
    t = timed(fn, libs, device=profile, device_reps=5, warmup=2, reps=GN_TIME_REPS)
    t.setdefault("device_ms", None)
    return t


def layout_name(kernel):
    """"nk" or "csr": the layout of a GraphNetBlock wrapper."""
    return "csr" if kernel.__name__.endswith("csr") else "nk"


def gn_instance_check(label, kernel, plain, rows, lay, model, x, e, raw, variants, card,
                      profile=True):
    """Rows 1-4 (``kernel``, a layout's wrapper) at one width and activation
    on these inputs: each variant (folded, first, middle, last) forward
    against its plain version (KERNEL_TOL) and backward against its plain
    backward and fp32 (utils/gradcheck.py); the middle block's backward
    the same bits on two calls, its times (CUDA events over GN_TIME_REPS
    calls, the plain version's, the profiler's device ms unless not
    ``profile``: then None) and bounds. Returns {backward: record
    fields}."""
    import torch
    from graph_physics_tpu_torch.utils import gradcheck

    blocks = model.processor_list
    table = {"folded": (blocks[0], raw, model.edges_encoder, False),
             "first": (blocks[0], e, None, False), "middle": (blocks[1], e, None, False),
             "last": (blocks[-1], e, None, True)}
    gen = torch.Generator(device=x.device).manual_seed(49)
    out = {False: {"max_abs_err": 0.0}, True: {"max_abs_err": 0.0}}
    for name in variants:
        blk, ee, en, last = table[name]
        args = (x, ee, *rows, blk.edge_block, blk.node_block, lay)
        kw = dict(encoder_params=en, last_block=last)
        with torch.inference_mode():
            before = kernel.launches
            xk, ek = kernel(*args, **kw)
            xp, ep = plain(*args, **kw, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            log(f"{label} forward kernel check [{name}] ({kernel.launches - before} launch)")
            if kernel.launches != before + 1:
                raise AssertionError(f"{label} [{name}]: the forward kernel did not launch once")
            err = compare("x_out", xk, xp, KERNEL_TOL)
            if not last:  # a folded block's masked rows hold enc(raw): valid rows
                err = max(err, compare("e_out", ek, ep, KERNEL_TOL,
                                       rows=rows[-1] if en is not None else None))
            out[False]["max_abs_err"] = max(out[False]["max_abs_err"], err)
            del xk, ek, xp, ep
            if name == "middle":
                fn = lambda: late(kernel)(*args, **kw)  # noqa: E731
                out[False].update(
                    gn_times(fn, gn_libs(layout_name(kernel), x.shape[-1], False), profile),
                    plain_ms=cuda_ms(lambda: plain(*args, **kw, compute_dtype=torch.bfloat16),
                                     warmup=1, reps=3))
        cot_x = torch.randn(x.shape, generator=gen, device=x.device).to(torch.bfloat16)
        cot_e = torch.randn((lay.total_rows,) + x.shape[1:], generator=gen,
                            device=x.device).to(torch.bfloat16)
        before = kernel.backward_launches
        grad_rows, ok, kept = gradcheck.check_block_backward(
            x, ee, rows, (en, blk.edge_block, blk.node_block), lay, last, cot_x, cot_e)
        torch.cuda.synchronize()
        log(f"{label} backward kernel check [{name}] ({kernel.backward_launches - before} "
            "launch; against the plain backward, both against fp32)")
        log_grad_rows(grad_rows)
        if kernel.backward_launches != before + 1 or not ok:
            raise AssertionError(f"{label} [{name}]: the backward kernel did not launch once, "
                                 "or is out of bounds")
        out[True]["max_abs_err"] = max(out[True]["max_abs_err"],
                                       max(r.get("max_abs_err", float("inf")) for r in grad_rows))
        if name == "middle":
            fn = lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True)  # noqa: E731
            g1, g2 = fn(), fn()
            if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
                raise AssertionError(f"{label}: the backward gives other bits on a second call")
            del g1, g2
            out[True].update(
                gn_times(fn, gn_libs(layout_name(kernel), x.shape[-1], True), profile),
                plain_ms=cuda_ms(lambda: torch.autograd.grad(*kept["plain"], retain_graph=True),
                                 warmup=1, reps=3))
            for bwd in (False, True):
                out[bwd]["bound_ms"], out[bwd]["bound_by"] = bound(
                    *gn_block_work(x, e, rows[-1], blk, backward=bwd))
        del kept
    torch.cuda.empty_cache()
    for bwd in (False, True):
        f = out[bwd]
        dev = "not profiled" if f["device_ms"] is None else f"{f['device_ms']:.4f}"
        log(f"  {label} middle block {'backward' if bwd else 'forward'}: kernel {f['ms']:.4f} "
            f"ms (device {dev}), plain {f['plain_ms']:.4f} ms, bound "
            f"{f['bound_ms']:.6g} ms ({f['bound_by']}){parent_note(f)} ({card})")
    return out


def gn_seam_check(label, kernel, plain, rows, lay, model, x, e, gen):
    """The world seam (``extra_agg``) of the middle block: forward against its
    plain version, backward (dx, de, dea, every weight gradient) against its
    plain backward and fp32. Returns (forward, backward) max abs errors."""
    import torch
    from graph_physics_tpu_torch.utils import gradcheck

    blk = model.processor_list[1]
    n, b, h = x.shape
    extra = (0.3 * torch.randn((n, b, h), generator=gen, device=x.device)).to(torch.bfloat16)
    args = (x, e, *rows, blk.edge_block, blk.node_block, lay)
    with torch.inference_mode():
        xk, ek = kernel(*args, extra_agg=extra)
        xp, ep = plain(*args, extra_agg=extra, compute_dtype=torch.bfloat16)
        log(f"{label} world seam forward check [middle]")
        f_err = max(compare("x_out", xk, xp, KERNEL_TOL), compare("e_out", ek, ep, KERNEL_TOL))
    cot_x = torch.randn(x.shape, generator=gen, device=x.device).to(torch.bfloat16)
    cot_e = torch.randn(e.shape, generator=gen, device=x.device).to(torch.bfloat16)
    before = kernel.backward_launches
    grad_rows, ok, _ = gradcheck.check_block_backward(
        x, e, rows, (None, blk.edge_block, blk.node_block), lay, False, cot_x, cot_e, extra=extra)
    log(f"{label} world seam backward check [middle] (dx, de, dea against the plain backward, "
        "all against fp32)")
    log_grad_rows(grad_rows)
    if kernel.backward_launches != before + 1 or not ok:
        raise AssertionError(f"{label}: the seam's backward did not launch once, or is out of "
                             "bounds")
    return f_err, max(r.get("max_abs_err", float("inf")) for r in grad_rows)


def gn_instance_phase(device, card, build_log):
    """Phase 49: every new instance of rows 1-4 (gn_instances) against its
    plain version, forward and backward, at the cylinder NK shape (B =
    GN_CHECK_BATCH) and a graded CSR shape (GN_CHECK_GRADED): relu at
    hidden 16 to 1 every variant in NK (the first block folded at 16 and
    8, on encoded edges below), the middle block otherwise; the world seam
    at GN_SEAM_SMALL in both layouts; ptxas's registers and spills, times
    and bounds. Returns {record name: record} without launches."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    resources = kernel_resources(build_log, ("gn_nk_", "gn_csr_", "gn_partial", "reduce_",
                                             "gnw"))
    gen = torch.Generator(device=device).manual_seed(490)

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)

    instances = gn_instances()
    records = {}
    for layout in ("nk", "csr"):
        for h in sorted({h for lay, h, _ in instances if lay == layout}):
            if layout == "nk":
                setup = entry.cylinder_setup(device, hidden=h, mp_steps=3, batch=GN_CHECK_BATCH)
                kernel, plain = nk_ops.fused_gn_block_nk, nk_ops.fused_gn_block_nk_reference
                rows = (setup.graph.senders, setup.graph.edge_mask)
            else:
                setup = entry.graded_setup(device, num_nodes=GN_CHECK_GRADED[0], hidden=h,
                                           mp_steps=3, batch=GN_CHECK_GRADED[1])
                kernel, plain = csr_ops.fused_gn_block_csr, csr_ops.fused_gn_block_csr_reference
                rows = (setup.graph.senders, setup.graph.receivers, setup.graph.edge_mask)
            model, lay = setup.simulator.model, setup.tiling
            n, b = setup.graph.x.shape[:2]
            x, e, raw = randn(n, b, h), randn(lay.total_rows, b, h), randn(lay.total_rows, b, 3)
            for act in [a for lay_, h_, a in instances if lay_ == layout and h_ == h]:
                set_block_activation(model, act)
                label = f"hidden {h}, {act}, {layout.upper()} [{n}, {b}]"
                variants = ([first_variant(h), "middle", "last"] if act == "relu" and layout == "nk"
                            else ["middle"])
                fields = gn_instance_check(label, kernel, plain, rows, lay, model, x, e, raw,
                                           variants, card)
                for bwd in (False, True):
                    rec = gn_instance_record(layout, h, act, bwd)
                    records[rec["name"]] = dict(
                        rec, route="cuda", launches=0, library_ms=None, shape=[n, b, h],
                        variants=variants, **fields[bwd],
                        ptxas=gn_instance_ptxas(resources, layout, h, act, bwd))
                if act == "relu" and h in GN_SEAM_SMALL:
                    errs = gn_seam_check(f"hidden {h}, {layout.upper()} [{n}, {b}]", kernel,
                                         plain, rows, lay, model, x, e, gen)
                    for bwd, err in zip((False, True), errs):
                        r = records[gn_instance_record(layout, h, act, bwd)["name"]]
                        r["max_abs_err"] = max(r["max_abs_err"], err)
                        r["world_checked"] = True
            set_block_activation(model, "relu")
            del setup, x, e, raw
            torch.cuda.empty_cache()
    for key, rec in records.items():
        for name, use in rec["ptxas"].items():
            log(f"ptxas, {key}: {name}: {use}")
    return records


def gn_sweep_phase(device, card):
    """Phase 50: each new instance on its path, counts set to 0 just before:
    a GN_SWEEP_BLOCKS-block ``epd`` whose blocks take the instance's width
    and activation, its eval forward and one train step on the cylinder
    (NK, GN_SWEEP_MESH, B=GN_SWEEP_BATCH) and on a GN_SWEEP_GRADED graded
    mesh (CSR), each against the plain path (forward SLICE_TOL, step-1 loss
    STEP1_LOSS_RTOL), every block launching rows 1/2 (3/4) once forward and
    once backward. Returns {record name: launches}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    launches = defaultdict(int)
    for h, act in sorted({(h, a) for _, h, a in gn_instances()}):
        for layout in ("nk", "csr"):
            if layout == "nk":
                train = entry.cylinder_train_setup(device, nx=GN_SWEEP_MESH[0],
                                                   ny=GN_SWEEP_MESH[1], hidden=h,
                                                   mp_steps=GN_SWEEP_BLOCKS,
                                                   batch=GN_SWEEP_BATCH)
                kernel = nk_ops.fused_gn_block_nk
            else:
                train = entry.graded_train_setup(device, num_nodes=GN_SWEEP_GRADED[0],
                                                 batch=GN_SWEEP_GRADED[1], hidden=h,
                                                 mp_steps=GN_SWEEP_BLOCKS)
                kernel = csr_ops.fused_gn_block_csr
            sim, graph = train.simulator, train.graph
            set_block_activation(sim.model, act)
            plain_sim = plain_copy(sim)
            plain_state, plain_step = entry.make_trainer(plain_sim)
            reset_counts([kernel])
            out = sim.forward(graph, is_training=False)
            m = train.train_step(train.state, graph, torch.Generator(device).manual_seed(50))
            torch.cuda.synchronize()
            got = launch_counts(kernel)
            ref = plain_sim.forward(graph, is_training=False)
            mp = plain_step(plain_state, graph, torch.Generator(device).manual_seed(50))
            rel = abs(m["loss"].item() - mp["loss"].item()) / abs(mp["loss"].item())
            want = (2 * GN_SWEEP_BLOCKS, GN_SWEEP_BLOCKS)
            log(f"phase 50 [hidden {h}, {act}, {type(train.tiling).__name__}, {graph.x.shape[0]} "
                f"nodes x {graph.x.shape[1]}]: launches (forward, backward) {got}, expected "
                f"{want}; step-1 loss {m['loss'].item():.6g} against the plain path's "
                f"{mp['loss'].item():.6g} (relative {rel:.3g}, limit {STEP1_LOSS_RTOL})")
            compare("net_out", out.net_out, ref.net_out, SLICE_TOL, rows=graph.node_mask)
            if got != want or rel > STEP1_LOSS_RTOL or not (
                    torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise AssertionError(f"phase 50 [hidden {h}, {act}, {layout}]: launches {got} or "
                                     "the loss off the plain path's")
            key = gn_instance_record(layout, h, act, False)["name"]
            launches[key] += got[0]
            launches[f"{key}_backward"] += got[1]
            del train, sim, plain_sim, plain_state, plain_step
    torch.cuda.empty_cache()
    return dict(launches)


def main_block_check(label, model, graph, nk, card, seed):
    """Rows 1/2 on a main path's middle block (``model``'s second, NK
    layout ``nk``) at that path's shape, on random inputs from ``seed``: the
    forward launched once against its plain version (KERNEL_TOL), the
    backward launched once against its plain backward and fp32
    (utils/gradcheck.py); times (CUDA events, the profiler's device ms, the
    plain version's) and bounds. Returns {backward: record fields}."""
    import torch
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.utils import gradcheck

    kernel, blk = nk_ops.fused_gn_block_nk, model.processor_list[1]
    n, b = graph.x.shape[:2]
    h = blk.hidden_size
    gen = torch.Generator(device=graph.x.device).manual_seed(seed)
    x = (0.5 * torch.randn((n, b, h), generator=gen, device=gen.device)).to(torch.bfloat16)
    e = (0.5 * torch.randn((nk.total_rows, b, h), generator=gen,
                           device=gen.device)).to(torch.bfloat16)
    rows = (graph.senders, graph.edge_mask)
    args = (x, e, *rows, blk.edge_block, blk.node_block, nk)
    with torch.inference_mode():
        reset_counts([kernel])
        xk, ek = kernel(*args)
        xp, ep = nk_ops.fused_gn_block_nk_reference(*args, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if launch_counts(kernel) != (1, 0):
            raise AssertionError(f"{label}: the middle block's forward kernel did not launch once")
        log(f"{label} forward kernel check [middle, B={b}]")
        f_err = max(compare("x_out", xk, xp, KERNEL_TOL), compare("e_out", ek, ep, KERNEL_TOL))
        del xk, ek, xp, ep
        fwd = dict(timed(lambda: late(kernel)(*args), gn_libs("nk", h, False), device=True),
                   plain_ms=cuda_ms(lambda: nk_ops.fused_gn_block_nk_reference(
                       *args, compute_dtype=torch.bfloat16)), max_abs_err=f_err)
    cots = [torch.randn(t.shape, generator=gen, device=gen.device).to(torch.bfloat16)
            for t in (x, e)]
    before = kernel.backward_launches
    stats, ok, kept = gradcheck.check_block_backward(
        x, e, rows, (None, blk.edge_block, blk.node_block), nk, False, *cots)
    torch.cuda.synchronize()
    log(f"{label} backward kernel check [middle, B={b}] ({kernel.backward_launches - before} "
        "launch; against the plain backward, both against fp32)")
    log_grad_rows(stats)
    if kernel.backward_launches != before + 1 or not ok:
        raise AssertionError(f"{label}: the middle block's backward did not launch once, or is "
                             "out of bounds")
    bwd = backward_times(f"{label} backward [middle, B={b}]",
                         lambda: torch.autograd.grad(*kept["kernel"], retain_graph=True),
                         lambda: torch.autograd.grad(*kept["plain"], retain_graph=True),
                         gn_libs("nk", h, True), card)
    bwd["max_abs_err"] = max(r["max_abs_err"] for r in stats)
    if h in WIDE_HIDDEN:
        depths = (len(blk.edge_block.denses), len(blk.node_block.denses), 0)
        bwd["scratch_bytes"], bwd["parent_scratch_bytes"] = scratch_note(
            f"{label} middle block at B={b}", "nk", h, n, b, nk.total_rows, 0, depths)
    del kept
    out = {}
    for backward, t in ((False, fwd), (True, bwd)):
        bd = bound(*gn_block_work(x, e, graph.edge_mask, blk, backward=backward))
        out[backward] = dict(ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                             bound_ms=bd[0], bound_by=bd[1], max_abs_err=t["max_abs_err"],
                             shape=[n, b, h], **{k: t[k] for k in t if k.startswith(
                                 ("parent_", "scratch_"))})
        log(f"{label} middle block {'backward' if backward else 'forward'} at B={b}: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, bound "
            f"{bd[0]:.6g} ms ({bd[1]}){parent_note(t)} ({card})")
    del x, e, cots
    torch.cuda.empty_cache()
    return out


def gn_main_phase(device, card):
    """Phase 51, the main path of phases 49-51: ``epd`` at hidden 16
    (entry.cylinder_train_setup(hidden=16): 5 blocks, B=128, the cylinder
    mesh, NK, relu, the encoder folded): the middle block's kernels timed
    at B=128 against their plain versions; 20 train steps against the plain
    path (training_phase), the step's wall, device and enqueue time; the
    model through Trainer.fit (GN_FIT_TRAJECTORIES trajectories, B=128,
    GN_FIT_EPOCHS epoch, a VAL_STEPS-step validation rollout) and predict
    from its checkpoint: launches held to the prediction, predict's RMSE
    validate's. Returns ({record name: launches}, {record name: times at
    the slice's shape}, facts)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.cli import predict as predict_cli
    from graph_physics_tpu_torch.cli.common import load_inference_stack
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    kernel, h = nk_ops.fused_gn_block_nk, GN_MAIN_HIDDEN
    train = entry.cylinder_train_setup(device, hidden=h)
    model, graph = train.simulator.model, train.graph
    b = graph.x.shape[1]
    n_blocks = len(model.processor_list)
    slice_times = {gn_instance_record("nk", h, "relu", bwd)["name"]: fields for bwd, fields in
                   main_block_check(f"phase 51, hidden-{h} NK", model, graph, train.tiling,
                                    card, 51).items()}

    _, plain_state, plain_step, step_launches = training_phase(
        f"hidden-{h} epd training", train, [kernel], 51)
    st = step_timing(train, plain_state, plain_step, 52)
    idle = 1.0 - st["train_step_device_ms"] / st["train_step_ms"]
    log(f"hidden-{h} epd train step B={b}: {st['train_step_ms']:.4f} ms "
        f"({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms, idle share {idle:.3f}; the host enqueues a step in "
        f"{st['train_step_host_enqueue_ms']:.4f} ms), plain path {st['train_step_plain_ms']:.4f} "
        f"ms ({card})")
    del train, plain_state, plain_step
    torch.cuda.empty_cache()

    param = cylinder_param()
    param["model"] = dict(param["model"], hidden_size=h)
    train_ds, val_ds = fit_datasets(GN_FIT_TRAJECTORIES)
    tr = fit_trainer(param, train_ds, val_ds, "fit_h16", device, epochs=GN_FIT_EPOCHS)
    reset_counts([kernel])
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {kernel.__name__: launch_counts(kernel)}
    steps, records = tr.state.step, epoch_records(tr)
    log(f"fit, epd at hidden {h} ({n_blocks} blocks, bf16, {type(tr.sim.model.tiling).__name__} "
        f"layout; {GN_FIT_TRAJECTORIES} trajectories of {FIT_FRAMES} frames, B={FIT_BATCH}, "
        f"{GN_FIT_EPOCHS} epoch, {steps} steps, validation {VAL_STEPS} rollout steps): "
        f"{fit_s:.1f} s ({card})")
    for r in records:
        log(f"  epoch {int(r['epoch'])}: train_loss_epoch {r['train_loss_epoch']:.6g} "
            f"val_all_rollout_rmse {r['val_all_rollout_rmse']:.6g} val_1step_rmse "
            f"{r['val_1step_rmse']:.6g} ({r['epoch_time_s']:.2f} s)")
    want = (n_blocks * (steps + GN_FIT_EPOCHS * VAL_STEPS), n_blocks * steps)
    log(f"  launches (forward, backward): {fit_launches[kernel.__name__]}; expected {want}")
    values = [r[k] for r in records for k in ("train_loss_epoch", "val_all_rollout_rmse")]
    if (len(records) != GN_FIT_EPOCHS or not all(math.isfinite(v) for v in values)
            or fit_launches[kernel.__name__] != want):
        raise AssertionError(f"phase 51: {steps} steps, launches {fit_launches}, records "
                             f"{records}")
    cfg_path = Path(tr.cfg.out_dir) / tr.cfg.run_name / "cylinder_h16.json"
    cfg_path.write_text(json.dumps(param))
    args = predict_cli.build_argparser().parse_args([
        "--training_parameters_path", str(cfg_path), "--model_path", tr.ckpt_dir, "--bf16",
        "--fused", "--device", str(device)])
    reset_counts([kernel])
    stack = load_inference_stack(args, dataset=val_ds)
    pred = predict_cli.predict(stack, fused=True)[0]
    torch.cuda.synchronize()
    predict_launches = {kernel.__name__: launch_counts(kernel)}
    want_rmse = records[-1]["val_all_rollout_rmse"]
    rel = abs(pred.rmse_all_rollout - want_rmse) / want_rmse
    want = (n_blocks * VAL_STEPS, 0)
    log(f"predict, epd at hidden {h}: checkpoint step {stack.step}, rollout of "
        f"{pred.predictions.shape[0]} steps, launches (forward, backward) "
        f"{predict_launches[kernel.__name__]}, expected {want}: rmse_all_rollout "
        f"{pred.rmse_all_rollout:.8g}, validate reported {want_rmse:.8g} (relative difference "
        f"{rel:.3g}, limit {PREDICT_RTOL})")
    if (stack.step != steps or rel > PREDICT_RTOL
            or predict_launches[kernel.__name__] != want):
        raise AssertionError("phase 51: predict's rollout is not validate's, or its launches "
                             f"{predict_launches} are not {want}")
    total = merge_launches(step_launches, fit_launches, predict_launches)[kernel.__name__]
    key = gn_instance_record("nk", h, "relu", False)["name"]
    launches = {key: total[0], f"{key}_backward": total[1]}
    facts = {"train_step": st, "idle_share": idle, "fit_s": fit_s,
             "predict_rmse": pred.rmse_all_rollout, "validate_rmse": want_rmse}
    return launches, slice_times, facts


def gn_width_phases(device, card, build_log):
    """Phases 49-51: the new instances of rows 1-4 checked and timed (49),
    each on its path (50), ``epd`` at hidden 16 trained, fitted and
    predicted (51). Returns their records, with the launches of phase 50,
    or of phase 51 for the main path's instance (phase 50's under
    "sweep_launches"), and the main instance's times and errors at the
    slice's shape."""
    t0 = time.perf_counter()
    records = gn_instance_phase(device, card, build_log)
    t1 = time.perf_counter()
    launches = gn_sweep_phase(device, card)
    t2 = time.perf_counter()
    main_launches, slice_times, facts = gn_main_phase(device, card)
    log(f"phases 49-51: {t1 - t0:.1f} s, {t2 - t1:.1f} s, {time.perf_counter() - t2:.1f} s")
    log("hidden-16 epd " + json.dumps({"card": card, **facts}))
    if set(main_launches) - set(records):
        raise AssertionError(f"phase 51: launches of no record: {main_launches}")
    out = []
    for key, rec in records.items():
        rec["launches"] = launches.pop(key, 0)
        if key in main_launches:  # the main path's own count; phase 50's beside it
            rec["sweep_launches"], rec["launches"] = rec["launches"], main_launches[key]
        if rec["launches"] == 0:
            raise AssertionError(f"phases 50-51: {key} never launched on its path")
        if key in slice_times:
            rec["slice"] = slice_times[key]
        out.append(rec)
    if launches:
        raise AssertionError(f"phases 50-51: launches of no record: {launches}")
    return out


#: phases 52-53: the MLP depths rows 1-4 take besides 4 (each with and
#: without the RMSNorm tail) and the widths phase 52 holds them at: the
#: tile family at 32 and 8, the wide kernels at 64 and 128
GN_DEPTHS = (1, 2, 3, 5, 8)
GN_DEPTH_HIDDEN = (32, 8, 64, 128)
#: phase 52: the (depth, norm) cases whose world seam is checked and whose
#: device time the profiler takes (every case is timed by CUDA events)
GN_DEPTH_PROFILED = ((3, False), (8, True))
#: phase 53: MeshGraphNets' MLPs (App. A of the paper: two hidden layers,
#: 3 Dense layers) on the MGN-width ``epd``, and the cylinder ``epd`` at
#: hidden 32 with 2-layer MLPs without the norm
GN_MGN_DEPTH = 3
GN_BARE_HIDDEN, GN_BARE_DEPTH = 32, 2


def gn_depth_cases():
    """(depth, norm) of every MLP shape phases 52-53 hold: GN_DEPTHS, each
    with and without the RMSNorm tail."""
    return [(d, norm) for d in GN_DEPTHS for norm in (True, False)]


def depth_key(depth, norm):
    """A record's key of one MLP shape: the depth, "_bare" without the norm."""
    return f"{depth}" + ("" if norm else "_bare")


def gn_depth_record(layout, h, backward):
    """The kernels-line keys of row 1-4 (``layout``, ``backward``) at hidden
    ``h`` with MLPs of another depth than 4 or without the RMSNorm tail:
    fused_gn_block_{layout}_h{h}_depths[_backward]."""
    rec = gn_instance_record(layout, h, "relu", backward)
    rec["name"] = rec["name"].replace(f"_h{h}", f"_h{h}_depths")
    return rec


def set_block_depth(model, nb_of_layers, layer_norm, seed):
    """Every GraphNetBlock of ``model`` rebuilt with ``nb_of_layers`` Dense
    layers a MLP and an RMSNorm tail when ``layer_norm`` (weights drawn
    from ``seed`` as entry's simulators draw theirs; the encoders stay):
    what GraphNetBlock(nb_of_layers=..., layer_norm=...) builds, for a
    model whose processors pass neither, as in JAX. A trainer made before
    holds the old parameters: make a new one."""
    import torch
    from graph_physics_tpu_torch.models.layers import GraphNetBlock, reset_parameters

    device = next(model.parameters()).device
    for i, blk in enumerate(model.processor_list):
        new = GraphNetBlock(blk.hidden_size, nb_of_layers=nb_of_layers, layer_norm=layer_norm,
                            is_last_block=blk.is_last_block, dtype=blk.dtype,
                            activation=blk.activation)
        reset_parameters(new, torch.Generator().manual_seed(seed + i))
        model.processor_list[i] = new.to(device)


def with_block_depth(train, nb_of_layers, layer_norm, seed):
    """An entry train setup whose blocks have ``nb_of_layers`` and
    ``layer_norm`` (set_block_depth), with a fresh trainer for them."""
    from graph_physics_tpu_torch import entry

    set_block_depth(train.simulator.model, nb_of_layers, layer_norm, seed)
    state, step = entry.make_trainer(train.simulator, train.device_preprocess, train.loss_fn,
                                     train.gradient_method)
    return dataclasses.replace(train, state=state, train_step=step)


def gn_depth_ptxas(resources, layout, h, backward):
    """The ptxas reports of the kernels an other-depth case runs: at hidden
    64 and 128 the width's kernels (the same as a 4-layer MLP's); below,
    the forward's (depth a run-time bound there) or the backward's deep
    instances, the pre-pass, the sender pass and the ordered sums."""
    if h in WIDE_HIDDEN:
        return gn_instance_ptxas(resources, layout, h, "silu", backward)
    other = "csr" if layout == "nk" else "nk"
    out = {}
    for name, use in resources.items():
        if f"ILi{h}E" not in name or f"gn_{other}_" in name:
            continue
        bwd = "bwd" in name or "reduce" in name
        if bwd != backward and "partial" not in name:
            continue
        if bwd and ("nodemlp" in name or "row_kernel" in name) and "deep" not in name:
            continue
        out[name] = use
    return out


def gn_depth_instance_phase(device, card, build_log):
    """Phase 52: rows 1-4 with MLPs of every depth in GN_DEPTHS, with and
    without the RMSNorm tail (gn_depth_cases), at GN_DEPTH_HIDDEN in both
    layouts, each against its plain version forward and backward at phase
    49's shapes (the cylinder NK mesh at B=GN_CHECK_BATCH, the graded CSR
    mesh of GN_CHECK_GRADED): in NK the first block (the edge encoder
    folded, 4 layers with its norm, as an ``epd`` builds it) and a middle
    block, in CSR a middle block; the world seam at GN_DEPTH_PROFILED;
    the middle block's backward the same bits on two calls; each case's
    times by CUDA events, the profiler's device ms at GN_DEPTH_PROFILED,
    bounds; ptxas's registers and spills. Returns {record name: record}
    without launches, each case under "depths"."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    resources = kernel_resources(build_log, ("gn_nk_", "gn_csr_", "gn_partial", "reduce_",
                                             "gnw"))
    gen = torch.Generator(device=device).manual_seed(520)

    def randn(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)

    records = {}
    for layout in ("nk", "csr"):
        for h in GN_DEPTH_HIDDEN:
            if layout == "nk":
                setup = entry.cylinder_setup(device, hidden=h, mp_steps=3, batch=GN_CHECK_BATCH)
                kernel, plain = nk_ops.fused_gn_block_nk, nk_ops.fused_gn_block_nk_reference
                rows = (setup.graph.senders, setup.graph.edge_mask)
            else:
                setup = entry.graded_setup(device, num_nodes=GN_CHECK_GRADED[0], hidden=h,
                                           mp_steps=3, batch=GN_CHECK_GRADED[1])
                kernel, plain = csr_ops.fused_gn_block_csr, csr_ops.fused_gn_block_csr_reference
                rows = (setup.graph.senders, setup.graph.receivers, setup.graph.edge_mask)
            model, lay = setup.simulator.model, setup.tiling
            n, b = setup.graph.x.shape[:2]
            x, e, raw = randn(n, b, h), randn(lay.total_rows, b, h), randn(lay.total_rows, b, 3)
            variants = [first_variant(h), "middle"] if layout == "nk" else ["middle"]
            recs = {bwd: dict(gn_depth_record(layout, h, bwd), route="cuda", launches=0,
                              library_ms=None, shape=[n, b, h], variants=variants, depths={},
                              max_abs_err=0.0,
                              ptxas=gn_depth_ptxas(resources, layout, h, bwd))
                    for bwd in (False, True)}
            for depth, norm in gn_depth_cases():
                set_block_depth(model, depth, norm, seed=52 + depth)
                key = depth_key(depth, norm)
                label = (f"hidden {h}, {depth} layers{'' if norm else ' without the norm'}, "
                         f"{layout.upper()} [{n}, {b}]")
                profiled = (depth, norm) in GN_DEPTH_PROFILED
                fields = gn_instance_check(label, kernel, plain, rows, lay, model, x, e, raw,
                                           variants, card, profile=profiled)
                if profiled:
                    errs = gn_seam_check(label, kernel, plain, rows, lay, model, x, e, gen)
                    for bwd, err in zip((False, True), errs):
                        fields[bwd]["max_abs_err"] = max(fields[bwd]["max_abs_err"], err)
                        fields[bwd]["world_checked"] = True
                for bwd in (False, True):
                    rec = recs[bwd]
                    rec["depths"][key] = dict(fields[bwd], launches=0)
                    rec["max_abs_err"] = max(rec["max_abs_err"], fields[bwd]["max_abs_err"])
            for bwd in (False, True):  # the record's times: the first profiled case's
                rep = recs[bwd]["depths"][depth_key(*GN_DEPTH_PROFILED[0])]
                recs[bwd].update({k: rep[k] for k in ("ms", "device_ms", "plain_ms",
                                                      "bound_ms", "bound_by")})
                records[recs[bwd]["name"]] = recs[bwd]
            del setup, model, x, e, raw
            torch.cuda.empty_cache()
    for key, rec in records.items():
        for name, use in rec["ptxas"].items():
            log(f"ptxas, {key}: {name}: {use}")
    return records


def gn_depth_sweep_phase(device, card):
    """Phase 52, on the path: each (depth, norm) of gn_depth_cases at each
    width of GN_DEPTH_HIDDEN, in both layouts, on a GN_SWEEP_BLOCKS-block
    ``epd`` whose blocks take that depth and tail (set_block_depth): its
    eval forward and one train step, counts set to 0 just before, on the
    cylinder (NK, GN_SWEEP_MESH, B=GN_SWEEP_BATCH) and a GN_SWEEP_GRADED
    graded mesh (CSR), each against the plain path (forward SLICE_TOL,
    step-1 loss STEP1_LOSS_RTOL), every block launching rows 1/2 (3/4)
    once forward and once backward. Returns {record name: {depth key:
    (forward, backward) launches}}."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_csr as csr_ops
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    launches = defaultdict(dict)
    for h in GN_DEPTH_HIDDEN:
        for layout in ("nk", "csr"):
            if layout == "nk":
                base = entry.cylinder_train_setup(device, nx=GN_SWEEP_MESH[0],
                                                  ny=GN_SWEEP_MESH[1], hidden=h,
                                                  mp_steps=GN_SWEEP_BLOCKS, batch=GN_SWEEP_BATCH)
                kernel = nk_ops.fused_gn_block_nk
            else:
                base = entry.graded_train_setup(device, num_nodes=GN_SWEEP_GRADED[0],
                                                batch=GN_SWEEP_GRADED[1], hidden=h,
                                                mp_steps=GN_SWEEP_BLOCKS)
                kernel = csr_ops.fused_gn_block_csr
            graph = base.graph
            for depth, norm in gn_depth_cases():
                train = with_block_depth(base, depth, norm, seed=520 + depth)
                sim = train.simulator
                plain_sim = plain_copy(sim)
                plain_state, plain_step = entry.make_trainer(plain_sim)
                reset_counts([kernel])
                out = sim.forward(graph, is_training=False)
                m = train.train_step(train.state, graph, torch.Generator(device).manual_seed(52))
                torch.cuda.synchronize()
                got = launch_counts(kernel)
                ref = plain_sim.forward(graph, is_training=False)
                mp = plain_step(plain_state, graph, torch.Generator(device).manual_seed(52))
                rel = abs(m["loss"].item() - mp["loss"].item()) / abs(mp["loss"].item())
                want = (2 * GN_SWEEP_BLOCKS, GN_SWEEP_BLOCKS)
                log(f"phase 52 [hidden {h}, {depth} layers{'' if norm else ' without the norm'}, "
                    f"{type(train.tiling).__name__}, {graph.x.shape[0]} nodes x "
                    f"{graph.x.shape[1]}]: launches (forward, backward) {got}, expected {want}; "
                    f"step-1 loss {m['loss'].item():.6g} against the plain path's "
                    f"{mp['loss'].item():.6g} (relative {rel:.3g}, limit {STEP1_LOSS_RTOL})")
                compare("net_out", out.net_out, ref.net_out, SLICE_TOL, rows=graph.node_mask)
                if got != want or rel > STEP1_LOSS_RTOL or not (
                        torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                    raise AssertionError(f"phase 52 [hidden {h}, {depth} layers, norm {norm}, "
                                         f"{layout}]: launches {got} or the loss off the plain "
                                         "path's")
                launches[gn_depth_record(layout, h, False)["name"]][depth_key(depth, norm)] = got
                del train, sim, plain_sim, plain_state, plain_step, out, ref, m, mp
            del base, graph
            torch.cuda.empty_cache()
    return dict(launches)


def gn_depth_main_phase(device, card):
    """Phase 53, the slice's path at full width: (a) ``epd`` at
    MeshGraphNets' width (entry.cylinder_train_setup(hidden=128): 15
    blocks, NK, the encoder folded) with GN_MGN_DEPTH-layer MLPs
    (set_block_depth): TRAIN_STEPS steps at B=128 with 15 + 15 launches a
    step, the step's wall, enqueue and device time; the first
    MGN_COMPARED_STEPS steps at B=MGN_PLAIN_BATCH against the plain path
    (training_phase, as phase 36); an eval forward at B=128 against the
    plain path (SLICE_TOL) and an R=ROLLOUT_WINDOWS x T=ROLLOUT_STEPS
    rollout against the plain path's (ROLLOUT_RTOL); (b) the cylinder
    ``epd`` at hidden GN_BARE_HIDDEN, B=128, with GN_BARE_DEPTH-layer MLPs
    without the norm: TRAIN_STEPS steps against the plain path. Before
    each, the middle block's rows 1/2 at B=128 against their plain versions
    forward and backward, timed (main_block_check). Returns ({record name:
    {depth key: (forward, backward) launches}}, {record name: the middle
    block's times and errors at B=128}, facts)."""
    import torch
    from graph_physics_tpu_torch import entry
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops
    from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn

    gn = nk_ops.fused_gn_block_nk
    launches = defaultdict(dict)
    facts = {}

    def add(h, depth, norm, got):
        slot = launches[gn_depth_record("nk", h, False)["name"]]
        key = depth_key(depth, norm)
        slot[key] = tuple(a + c for a, c in zip(slot.get(key, (0, 0)), got))

    d = GN_MGN_DEPTH
    train = with_block_depth(entry.cylinder_train_setup(device, hidden=MGN_HIDDEN,
                                                        mp_steps=MGN_BLOCKS), d, True, seed=53)
    g = train.graph
    b = g.x.shape[1]
    log(f"MeshGraphNets-width epd with {d}-layer MLPs: {int(g.n_node)} nodes x {b} samples, "
        f"hidden {MGN_HIDDEN}, {MGN_BLOCKS} blocks, {type(train.tiling).__name__} layout, "
        f"{sum(p.numel() for p in train.simulator.parameters())} parameters")
    slices = {}

    def add_slice(h, depth, norm, model, graph, nk, seed):
        checked = main_block_check(
            f"phase 53, hidden-{h} NK, {depth} layers{'' if norm else ' without the norm'}",
            model, graph, nk, card, seed)
        for bwd, fields in checked.items():
            slices[gn_depth_record("nk", h, bwd)["name"]] = dict(fields,
                                                                 case=depth_key(depth, norm))

    add_slice(MGN_HIDDEN, d, True, train.simulator.model, g, train.tiling, 530)
    reset_counts([gn])
    torch.cuda.reset_peak_memory_stats()
    losses, norms, per_step, _, _ = train_run(train.train_step, train.state, train.simulator,
                                              g, 53, TRAIN_STEPS, [gn])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    add(MGN_HIDDEN, d, True, launch_counts(gn))
    log(f"MGN-width epd, {d} layers, training ({TRAIN_STEPS} steps, B={b}, kernel path): "
        f"launches per step (forward, backward) {sorted(set(per_step))}; max_memory_allocated "
        f"{peak / 2**30:.4f} GiB")
    log("  loss:      " + " ".join(f"{v:.6g}" for v in losses))
    log("  grad_norm: " + " ".join(f"{v:.6g}" for v in norms))
    if any(s != ((MGN_BLOCKS, MGN_BLOCKS),) for s in per_step) or not all(
            map(math.isfinite, losses + norms)):
        raise AssertionError(f"phase 53: launches per step {per_step}, or a non-finite loss or "
                             "gradient norm")
    reset_counts([gn])
    st = step_timing(train, None, None, 54, libs=gn_libs("nk", MGN_HIDDEN, True))
    add(MGN_HIDDEN, d, True, launch_counts(gn))
    idle = 1.0 - st["train_step_device_ms"] / st["train_step_ms"]
    log(f"MGN-width train step with {d}-layer MLPs B={b}: kernel path {st['train_step_ms']:.4f} "
        f"ms ({1000 * b / st['train_step_ms']:.1f} graph-steps/s; device time "
        f"{st['train_step_device_ms']:.4f} ms, idle share {idle:.3f}; the host enqueues a step "
        f"in {st['train_step_host_enqueue_ms']:.4f} ms){parent_step_note(st)} ({card})")
    facts["mgn_depth3_step"] = dict(st, peak_bytes=peak, idle_share=idle)
    del train
    torch.cuda.empty_cache()
    compared = with_block_depth(entry.cylinder_train_setup(
        device, hidden=MGN_HIDDEN, mp_steps=MGN_BLOCKS, batch=MGN_PLAIN_BATCH), d, True, seed=53)
    _, _, _, got = training_phase(
        f"MGN-width epd with {d}-layer MLPs at B={MGN_PLAIN_BATCH} against the plain path",
        compared, [gn], 55, steps=MGN_COMPARED_STEPS)
    add(MGN_HIDDEN, d, True, got[gn.__name__])
    del compared
    torch.cuda.empty_cache()

    setup = entry.cylinder_setup(device, hidden=MGN_HIDDEN, mp_steps=MGN_BLOCKS,
                                 num_steps=ROLLOUT_WINDOWS + ROLLOUT_STEPS + 1)
    set_block_depth(setup.simulator.model, d, True, seed=53)
    sim, graph = setup.simulator, setup.graph
    plain_sim = plain_copy(sim)
    reset_counts([gn])
    out = sim.forward(graph, is_training=False)
    frames = entry.rollout_frames(setup, range(ROLLOUT_WINDOWS), ROLLOUT_STEPS)
    res = make_batched_rollout_fn(sim)(frames)
    torch.cuda.synchronize()
    got = launch_counts(gn)
    want = (MGN_BLOCKS * (1 + ROLLOUT_STEPS), 0)
    log(f"MGN-width epd with {d}-layer MLPs: forward B={graph.x.shape[1]} and a "
        f"{ROLLOUT_WINDOWS} x {ROLLOUT_STEPS} rollout, launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"phase 53: forward and rollout launches {got}, not {want}")
    add(MGN_HIDDEN, d, True, got)
    ref = plain_sim.forward(graph, is_training=False)
    compare("net_out", out.net_out, ref.net_out, SLICE_TOL, rows=graph.node_mask)
    compare("outputs", out.outputs, ref.outputs, SLICE_TOL, rows=graph.node_mask)
    check_rollouts(f"MGN-width epd with {d}-layer MLPs", res,
                   make_batched_rollout_fn(plain_sim)(frames))
    facts["mgn_depth3_rollout_rmse"] = res.rmse_all_rollout.tolist()
    del setup, sim, plain_sim, out, ref, res, frames
    torch.cuda.empty_cache()

    h, d = GN_BARE_HIDDEN, GN_BARE_DEPTH
    bare = with_block_depth(entry.cylinder_train_setup(device, hidden=h), d, False, seed=56)
    add_slice(h, d, False, bare.simulator.model, bare.graph, bare.tiling, 560)
    _, plain_state, plain_step, got = training_phase(
        f"epd at hidden {h} with {d}-layer MLPs without the norm, B=128", bare, [gn], 56)
    add(h, d, False, got[gn.__name__])
    reset_counts([gn])
    st = step_timing(bare, plain_state, plain_step, 57)
    add(h, d, False, launch_counts(gn))
    log(f"hidden-{h} epd train step with {d}-layer MLPs without the norm B=128: kernel path "
        f"{st['train_step_ms']:.4f} ms (device time {st['train_step_device_ms']:.4f} ms; the "
        f"host enqueues a step in {st['train_step_host_enqueue_ms']:.4f} ms), plain path "
        f"{st['train_step_plain_ms']:.4f} ms ({card})")
    facts["bare_step"] = st
    del bare, plain_state, plain_step
    torch.cuda.empty_cache()
    return dict(launches), slices, facts


def gn_depth_phases(device, card, build_log):
    """Phases 52-53: rows 1-4 with MLPs of 1 to 8 Dense layers, with and
    without the RMSNorm tail, checked and timed and each on its path (52),
    the slice's path at full width (53). Returns their records: each case's
    phase-52 launches under "depths"; a record's launches phase 52's sum,
    or for the instances phase 53 runs its own count (phase 52's under
    "sweep_launches") with the times, bound and error of its middle block
    at B=128 (phase 52's worst error under "checks_max_abs_err", the
    block's under "slice")."""
    t0 = time.perf_counter()
    records = gn_depth_instance_phase(device, card, build_log)
    t1 = time.perf_counter()
    sweep = gn_depth_sweep_phase(device, card)
    t2 = time.perf_counter()
    main_launches, slices, facts = gn_depth_main_phase(device, card)
    log(f"phases 52-53: {t1 - t0:.1f} s, {t2 - t1:.1f} s, {time.perf_counter() - t2:.1f} s")
    log("depth epd " + json.dumps({"card": card, **facts}))
    for name, by_depth in sweep.items():
        for key, (fwd_n, bwd_n) in by_depth.items():
            for rec_name, n in ((name, fwd_n), (f"{name}_backward", bwd_n)):
                records[rec_name]["depths"][key]["launches"] += n
                records[rec_name]["launches"] += n
    main = {}
    for name, by_depth in main_launches.items():
        for key, (fwd_n, bwd_n) in by_depth.items():
            for rec_name, n in ((name, fwd_n), (f"{name}_backward", bwd_n)):
                main[rec_name] = main.get(rec_name, 0) + n
    if set(main) != set(slices) or set(main) - set(records):
        raise AssertionError(f"phase 53: launches {main} and checked blocks {sorted(slices)} "
                             "of other records")
    for key, rec in records.items():
        never = [k for k, v in rec["depths"].items() if v["launches"] == 0]
        if never:
            raise AssertionError(f"phase 52: {key} never launched on its path for {never}")
        if key in main:  # the main path's own count and times; phase 52's beside them
            if main[key] == 0:
                raise AssertionError(f"phase 53: {key} never launched on the main path")
            sl = slices[key]
            rec.update(sweep_launches=rec["launches"], launches=main[key],
                       checks_max_abs_err=rec["max_abs_err"], slice=sl,
                       **{k: sl[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                             "bound_by", "max_abs_err", "shape")})
    return list(records.values())


if __name__ == "__main__":
    main()
