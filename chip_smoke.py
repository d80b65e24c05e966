#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py               # full size: 12M x 256 f32
    python3 chip_smoke.py --rows 2000000

Phases (each prints one JSON line; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions, and
   the parallel ``nvcc`` build of every kernel (with ptxas register/spill
   lines).
2. kernels: each kernel's wrapper on card tensors at the main path's shapes
   (and at ragged shapes) against its plain PyTorch version evaluated in
   f64 on the same inputs, each output entry within its own tolerance
   (see ``held``); at the main path's shapes a deliberately wrong output
   must fail the same check. Kernel, plain, library-call and bound times.
   K1 (shifted Gram) at the PCA fit's padded 12M x 256 shape (which must
   beat its plain version; a wrong mirror of a diagonal tile's skipped
   quadrant is one of its controls) and at ragged shapes, on and off its
   float4 path (d % 4 != 0, a base off 16-byte alignment); at
   LinearRegression's shapes, with the controls: row scales m = √w (w
   uniform in [0.1, 2]) on the 12M × 256 rows, and 1,024,000 × 3,000 (a
   zero-copy view of them), timed beside its plain version and
   ``matmul(Xcᵀ, Xc)``.
   K2 (fused Lloyd step: 3xTF32 ``wgmma`` products on the tensor cores fed
   by TMA, the centres split into TF32 hi and lo once a launch, a fused
   argmin, and the accumulation's vector atomics overlapped with the next
   row block by a persistent grid) at 12M x 256 with k = 1024 and k =
   4,097 (its controls: a lost feature tile, a lost row range, and one-pass
   TF32 scores, which its rule must refuse) and at ragged shapes (d in {300,
   124, 3000, 257, 61} and a base off 16-byte alignment, k in {1, 37,
   130}); it must beat its plain version and one matmul + argmin +
   ``index_add_`` at both main shapes and take at most LLOYD_MS_MAX at k =
   1024.
   K3 (logistic loss + gradient) at K = 1 and, through its multinomial
   kernel, at K = 10 on the 12M rows (which must beat its plain version)
   and at ragged shapes, each with the kernel that ran it; K4 (kNN
   distance + top-k, 3xTF32 on the tensor cores) at 131,072 queries x 1M
   items x 256, k = 16, on a 4,096-row sample (its controls: shifted ids,
   and one-pass TF32 scores, which the band must refuse), at the join's
   4,096 queries x 1M (item splits and their merge), at the UMAP graph (k
   = 16) and transform (k = 15) shapes of 65,536 x 65,536 x 256 on a
   4,096-row sample, and in full at ragged shapes; it must beat its plain
   version at all four main shapes, one chunked addmm + topk at the kNN and
   UMAP-graph shapes, and take at most KNN_MS_MAX at the kNN shape; K10
   (one UMAP SGD epoch: its ROWS epilogue, the per-row sums, with streamed
   uniforms and with its own slot draws, whose bits must equal the plain
   hash's; its STEP epilogue, the whole epoch, with its draws, two launches
   equal bit for bit) on the rows of the 65,536 x 256 UMAP graph, at the
   transform's shape (65,536 rows, K = 15), on the rows of the
   umap_cluster graph (70,000 x 784, 30 neighbours, C = 10: the generic
   instance) and at that path's transform shape (70,000 rows, K = 30, a
   frozen 70,000 x 10 table), its controls a dropped repulsive term, a
   flipped hash bit and every head's second row skipped; at the first two
   it must beat the kernel it replaced (K10_PARENT_MS), and on a table and
   heads off 16 bytes it must give what it gives on aligned ones, bit for
   bit; K3's tile kernel (whole
   rows staged once in shared memory, the gradient held on chip) timed
   beside its autograd call at 200,000 rows of d = 3,000 (K = 1), d = 512
   (K = 10) and d = 256 (K = 32), and at the wide fit's 1,024,000 x 3,000
   (a view of the 12M x 256 rows, with its controls), each of which must
   run the tile kernel and beat its plain version, at ragged shapes (d =
   3,001, d % 4 != 0 with many classes, bases 4 bytes off 16-byte
   alignment, fewer rows than a tile); K3's route past the tile kernel's
   cap (multinomial 2 <= K <= 256: logits and gradient as two 3xTF32
   ``wgmma`` products, the softmax in the first one's epilogue) timed
   beside its autograd call at 200,000 rows of d = 256 and 1,024 (K = 64)
   and d = 2,048 (K = 120), and at the logreg_many fit's 1,024,000 x 1,024
   (K = 64, a view of the 12M x 256 rows), each with its controls (a
   one-pass TF32 version of its products among them, which the band must
   refuse at every timed route shape), each of which must run the route
   and beat its plain version, and at ragged shapes that launch every
   instance (d % 4 != 0, a base off alignment, fewer rows than a tile,
   padded classes, K = 2 at d = 5,000, K = 256, two launch pairs); K3's
   cluster kernel (binomial 16,380 < d <= 262,144: each row's columns
   split over the CTAs of a thread-block cluster, the partial logits
   exchanged through distributed shared memory, X read once) at 20,000 x
   20,000, the logreg_realsim fit's 72,309 x 20,958, 46,875 x 65,536 and
   11,718 x 262,144 (the last three views of the 12M x 256 rows), each
   with its controls (a dropped cluster rank among them), timed beside
   its autograd call and the general kernel it replaced there, each of
   which must run the cluster kernel and beat its plain version, autograd
   and the general kernel, and at ragged shapes with O(1) logits and every
   control that launch every cluster size its geometry picks and both its
   instances (d % 4 != 0, a base off alignment, fewer rows than clusters,
   5 rows); the general kernel at the
   shape it keeps (2,929 x 2^20), timed beside its autograd call; the
   forest kernels at the builder's own level layouts: K5 per node (every
   node's histogram of a level in one launch: rows read through the sort
   permutation, spans of SPAN_ROWS rows summed in row order and a node's
   spans folded in order, no atomics) at the deepest (level 12) and a
   shallow (level 2) call of the bench forest (131,072 x 256, 8 trees a
   batch, k = 16, 128 bins), the regressor's S = 3 level 12 and ragged
   shapes (nb in {32, 128, 255}, odd r_sub, bins past nb, empty nodes,
   nodes of several spans, per-tree and shared tables), exact for integer
   stats, repeatable bit for bit, a span's dropped row caught; it must beat
   its plain version and an index_select + scatter_add_ at the four main
   shapes, and the per-sub-block form's 0.7129 ms at bench level 12; K6
   per node (each node's 55 -> 64 ids picked from the full rows of 4,096
   bytes read through the sort permutation, K5's spans and fold) at the
   3,000-feature forest's levels 12 and 2 on 131,072 rows and level 12 on
   the reference's 1,000,000 rows, exact and repeatable bit for bit, a
   span's dropped row and a slot read at a wrong feature id caught, faster
   than route B (the per-row subset gather, then K5) and than a gather +
   scatter_add_ at all three, and at ragged shapes (n_features == d_pad
   with real-valued S = 3, nb in {32, 128, 255}, rows of 200 bytes, a table
   4 bytes off alignment, T = 1, empty nodes, nodes of many spans); K9 (the
   packed forest walked from the root in one launch a transform batch,
   with the leaf-payload sums or the leaf ids, and from a given hop 1, the
   TPU kernel's contract) on a batch of the bench forest (50 trees, depth
   13), rf_wide's (3,000 bytes a row, 8 trees), the GBT's (depth 8) and the
   reference regressor's (30 trees, depth 6: hop 1 alone), equal bit for
   bit to the plain route (hop 1 as gathers, hop 2, the payload sum), a
   moved hop-2 threshold, hop-1 threshold and leaf payload each moving its
   output, faster than step 0's route at the bench shape
   (ROUTE_MS_STEP0_RUN_A), and at ragged shapes (two tree groups with
   padding trees on 131,071 rows, a payload of 10, one row, rows too wide
   to stage); K8
   (packed-byte gather, one launch per group of 8 trees) at the byte
   indices the bins engine makes for 8 depth-13 trees (k = 63), for 8
   depth-8 trees (the GBT's k = 1), at 3,000 features (750 words) and at
   ragged shapes with out-of-range indices, equal to its plain version,
   and K7 (its one-index-set form) likewise, each timed over 200 calls
   also as device time alone (the calls queued behind a device wait) and
   host time a call, beside one ``torch.gather``, and each of its two
   instances (staged, direct) held and timed alone; K5 at the GBT's
   deepest split level (S = 4 logistic stats, one tree, all 256 features
   in one launch), within NODE_HIST_MS_MAX, and at its level 0, both equal
   bit for bit to the plain version on the host; at level 0 (one node of
   32 spans) that plain version with each node's spans folded in reverse
   order must be refused by that comparison.
3. end to end, each path with the launch counters zeroed just before it
   and read just after (every kernel of the path must have run): PCA(k=16),
   KMeans(k=1024, maxIter=10) and binomial LogisticRegression(maxIter=20)
   fit then transform through ``DataFrame`` on N x 256 f32 rows made from
   ``--seed``, with a 100k-row subset fitted on the card and on the CPU
   (plain path) and compared, and a 10-class (multinomial)
   LogisticRegression on those rows fitted on both and compared (its K3
   launches a path of their own); the reference's LogisticRegression
   benchmark config (maxIter=200, tol=1e-30, regParam=1e-5, binomial) on
   1,024,000 x 3,000 rows, a zero-copy view of the 12M x 256 host rows,
   with labels from a numpy hyperplane plus logistic noise (K3's tile
   kernel: its launches under ``launches_by_path["logreg_wide"]``), and its
   first 50,000 rows fitted with maxIter=20 on the card and on the CPU and
   compared; a 64-class LogisticRegression(maxIter=20, regParam=1e-5) on
   1,024,000 x 1,024 rows, a zero-copy view of the same host rows, with
   labels argmax(X W + Gumbel noise) from numpy (K3's route past the tile
   kernel's cap: its launches under ``launches_by_path["logreg_many"]``),
   held to the label map's own accuracy less 0.02, and its first 20,000
   rows fitted on the card and on the CPU and compared; the same
   benchmark config (binomial, maxIter=200, tol=1e-30, regParam=1e-5) at
   the shape of LIBSVM's real-sim, 72,309 x 20,958, a zero-copy view of
   the same host rows with hyperplane labels (K3's cluster kernel: its
   launches under ``launches_by_path["logreg_loss_grad_cluster"]``; the
   fit's copy and K3 time apart), held to the hyperplane's accuracy less
   0.02, and its first 20,000 rows fitted on the card and on the CPU at
   regParam 1e-5 (predictions held) and 1e-2 (coefficients held);
   NearestNeighbors(k=16).kneighbors of the
   first 131,072 of 1M of those rows against all 1M, and a join; UMAP(
   n_neighbors=15, random_state=42) fit, transform and save/load at
   65,536 x 256 (bench.py's blobs), held by trustworthiness on a 4,096-row
   sample, and a 20,000-row UMAP fitted on the card and on the CPU;
   umap_cluster: UMAP(n_neighbors=30, min_dist=0.0, n_components=10) fit
   and transform of 70,000 x 784 (MNIST's shape, 10 Gaussian blobs made on
   the card), held likewise, and its first 10,000 rows fitted on the card
   and on the CPU (random init); each UMAP path must launch K10 once an
   epoch; ann: ApproximateNearestNeighbors(k=16) at the default algoParams
   on bench.py's ANN workload (131,072 x 256 items from 64 blobs, its
   first 65,536 rows the queries): the IVF engine at nlist 362 and nprobe
   46, K2 launched by the index build (and first held and timed at the
   quantizer's shape, 131,072 x 256 at k = 362), no K4, recall@16 at least
   0.95 against K4's exact answer on 4,096 queries, the scan at nprobe =
   nlist on 1,024 equal to an f64 exact answer up to near ties, the bytes
   the scan's tiles gathered per search second, one query chunk's scan
   timed whole and by its gathers and bmms, and 65,536 items (below the
   gate) answered by the exact search, equal to NearestNeighbors bit for
   bit; umap_ivf: UMAP(n_neighbors=15, random_state=42) fit of 131,072
   rows of the umap path's blobs, where the default graph engine is IVF,
   and transform of their first 32,768: K2 in both index builds, no K4,
   K10 200 fit epochs, the fit's graph at recall@15 of at least 0.95
   against K4's exact graph on 4,096 rows, trustworthiness held as on the
   umap path; then K10 held and timed on the rows the path gave it (the
   fit's CSR rows of its IVF graph, the transform's 32,768 x 15 into the
   frozen table), each shape a kernels-line row with its launches;
   RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128) fit,
   transform, save/load and transform on the first 131,072 rows (bench.py's
   rf config), RandomForestRegressor(numTrees=8) on the same rows with a
   real-valued label, the reference's RandomForestRegressor(numTrees=30,
   maxDepth=6, maxBins=128) on them (rf_regressor_ref: K9 walks hop 1
   alone), RandomForestClassifier(numTrees=8, maxDepth=13,
   maxBins=128) on 1,000,000 x 3,000 rows (the reference's benchmark
   config but for 50 trees: K6 at every split level; transform, one K9
   launch a batch, and the bins engine on all of its rows) and its first 20,000 rows at
   depth 10 fitted on the card and on the CPU, each classifier's bins
   engine (K8) equal to its packed engine (K9) bit for bit, and an 8-tree
   depth-10 forest on 20,000 rows fitted on the card and on the CPU (the
   same draws: predictions agree on >= 99.9% of rows);
   GBTClassifier(maxIter=20, maxDepth=8, maxBins=128) fit, transform, bins
   engine (equal bit for bit) and save/load on the rf rows (bench.py's gbt
   config), GBTRegressor likewise on the regressor's label, and a 20,000-row
   10-round GBT fitted on the card and on the CPU (predictions agree on >=
   99.5% of rows); LinearRegression, the reference's three configs
   (``BASELINE.md:25``: OLS; regParam 1e-5 with elasticNetParam 0.5;
   regParam 1e-5) fit, transform and RegressionEvaluator (rmse) on the 12M
   × 256 host rows (``linreg``) and on their 1,024,000 × 3,000 view
   (``linreg_wide``), labels X·β* + b* + ε from ``--seed``: one K1 launch a
   fit, OLS's rmse within 1% of ε's σ and its coefficients against an f64
   solve on the card within a tolerance derived from K1's band and the
   condition number, and ``fitMultiple`` of the three with one K1 launch,
   one copy and models equal bit for bit to the separate fits'; and
   ``linreg_card_vs_cpu``: the three configs, a weightCol fit,
   fitIntercept=False and an unstandardized elastic net on ``--subset``
   rows, OLS and the elastic net on 20,000 × 3,000, on the card and on the
   CPU. The linreg, linreg_wide, logreg_realsim and logreg_1k rows also
   give the seconds of the fit's own copy (``shard_rows`` through the
   page-locked staging ring) and its share of the fit.
4. streamed (the out-of-core path): (a) the 12M × 256 host rows copied
   by a plain pageable ``copy_`` and by ``shard_rows`` in turns, GB/s of
   each, the ring's buffers page-locked and its copy stream not the
   compute stream; (c) ``streaming=True`` PCA(k=16) and LinearRegression
   ``fitMultiple`` of the three reference configs over those rows (an
   ``ArrayChunkSource``), each held to its f64 truth and to the resident
   fit of the same rows, the ``fitMultiple`` one moments pass and one Gram
   pass; (d) the north star: PCA(k=16) and the three-config ``fitMultiple``
   on 100,000,000 × 256 f32 rows (102.4 GB, more than the card holds) from
   a ``GeneratorChunkSource`` that yields views of a pool of host blocks,
   through each estimator's streaming fit function, held to the f64 truth
   of the whole set at a band derived from the chunks, peak device memory
   under STREAM_PEAK_MAX, one moments and one Gram pass (763 K1 launches)
   a fit, the ingest report's stage seconds; (e) where pyarrow imports, a
   parquet scan of 1,000,000 of the rows in 4 files, a streamed PCA fit
   and transform that leave it on disk, held to the in-memory fit and
   transform (else a line says it did not run). The K1 launches of these
   fits are ``launches_by_path["shifted_gram"]["streamed"]``. Then the
   streamed LogisticRegression (host L-BFGS/OWL-QN, each evaluation one
   chunked pass through K3): (f) K3 at the three chunk shapes it gets
   (131,072 × 256 binomial, 32,768 × 1,024 with 64 classes, 1,601 ×
   20,958 binomial) and their zero-padded last chunks, held with every
   control and timed; LogisticRegression(maxIter=3) streamed and resident
   on (g) the 12M × 256 rows, (h) the 64-class logreg_many rows (their
   predictions equal but for near ties) and (j) a CSR matrix of real-sim's
   shape through the sparse opt-in against the resident dense fit, each
   model's f64 objective held against an f64 reference fit of the same
   rows (the same host solver, f64 passes) at a band derived from K3's and
   the chunk count, one K3 launch a chunk of each objective pass and none
   of K3's plain version; (k) the north star: LogisticRegression(regParam=
   1e-5, maxIter=2) on 100,000,000 × 256 rows with binomial labels, its
   first and last evaluations held against their f64 truth from the pool,
   the model against the f64 reference fit, peak device memory under
   STREAM_PEAK_MAX. K3's launches there are the ``logreg_loss_grad_stream_*``
   rows of the kernels line (and the resident fits' the rows of their
   kernels). Then the streamed KMeans (Lloyd as one chunked pass an
   iteration and the k-means|| seeding passes, K2 on every chunk of each
   Lloyd, cost and candidate-count pass): (l) K2 at the chunk shapes it
   gets (131,072 x 256 at k = 1,024, 1,000 and 4,097) and their
   zero-padded last chunks (72,448 and 123,136 rows), held with its
   controls and timed as median device times, no chunk copied by its
   wrapper; (m) KMeans(k=1024) streamed and resident on the 12M rows:
   random init from the same seeds bit for bit, one Lloyd iteration of
   each held against the f64 one, 5-iteration fits' costs and centres
   within their compounded bands, at least
   KM_AGREE_MIN of predictions equal (the rest reported by near tie);
   k-means|| (the default, maxIter=10) within 2% of the resident cost, both
   seeding splits (``_fit_report``) side by side; (n) the north star: the
   reference's KMeans(k=1000, tol=1e-20, initMode="random"), maxIter cut to
   2, on 100,000,000 x 256 rows from a generator of views of the 12M
   rows' 131,072-row blocks: its seeds equal the rows the seed names, a
   maxIter=0 fit's cost held against its f64 truth from the pool, the
   fit's cost against an f64 walk's, peak device memory under
   STREAM_PEAK_MAX. K2's launches there are the ``lloyd_step_stream_*``
   rows of the kernels line (the resident fits' the ``lloyd_step`` row's).
   Then (o) the wire formats on the first 1,572,864 rows as a generator
   of 12 chunks: one chunk dequantized on the card at f16, int8 and e4m3
   f8, held entry by entry against its f32 rows (an int8 dequantize with
   its offset two steps off refused); streamed PCA(k=16) at f32 (held to
   its f64 truth), f16, int8, f8 and auto, the three-config
   LinearRegression ``fitMultiple`` at f32 (OLS to its f64 solve) and f16,
   KMeans(k=1024, random, maxIter 2) at f32 and int8, each narrow fit
   held against the f32 one at the JAX package's wire tolerances, with
   each wire's bytes, encode and host-copy seconds and seconds a pass;
   (p) checkpoint/resume on those rows: LogisticRegression(maxIter=5) and
   KMeans(k=1024, random, maxIter 4), each interrupted in the first pass
   after its iteration-2 checkpoint and fitted again, starting there (the
   passes it skipped), leaving no file, LogisticRegression equal to the
   uninterrupted fit bit for bit, KMeans within its band. Their K2 and K3
   launches are the ``stream_wire`` and ``stream_resume`` paths of the
   streamed rows, their K1 launches in ``streamed``.
5. float64 inputs (q, ``phase_f64``): the first 1,572,864 host rows in f64
   (3.2 GB at d = 256) with ``float32_inputs=False``: PCA(k=16), the
   three-config LinearRegression ``fitMultiple``, binomial
   LogisticRegression(maxIter 20) on labels no hyperplane separates,
   KMeans(k=1024, random, maxIter 5), streamed PCA(k=16) and
   LogisticRegression(maxIter 5) at 131,072-row chunks, each beside the same
   fit at f32, with seconds and peak device memory, and the four
   transforms (f64 columns; KMeans' int32). Truths on the card in f64: the
   covariance as one product with ``eigh``, OLS from the normal equations,
   an f64 L-BFGS of the phase's own objective. The f64 PCA and OLS fits
   within the f64 ``held`` band (u = 2⁻⁵³) of their truths and the f32 fits
   outside it (the negative control); the streamed f64 fits against the
   resident ones within 8·√n·u (PCA entry by entry, LogisticRegression on
   its f64 objective); LogisticRegression within the JAX package's f64
   test tolerance of its truth; KMeans f64 against f32 on >= 99.9% of
   predictions, costs within the f32 band. The f64 fits launch no K1, K2
   or K3 and call no plain version; the f32 fits launch each (the
   ``f64_phase_f32`` path of the ``shifted_gram``, ``lloyd_step``,
   ``logreg_loss_grad`` and ``logreg_loss_grad_stream_rows`` rows); each
   wrapper given an f64 card tensor raises.
6. tuning (r, ``phase_tuning``): the first 1,572,864 host rows with the
   phase's own binomial, 10-class and regression labels:
   CrossValidator(LogisticRegression(maxIter 20)) over regParam {1e-4,
   1e-2} × elasticNetParam {0, 0.5}, 3 folds, accuracy (its single pass:
   ``fitMultiple``, ``_combine``, one ``_transformEvaluate`` a fold),
   beside the per-map loop, ``parallelism=3`` and another fold seed, and on
   the first 131,072 rows beside the same CV on the CPU;
   CrossValidator(LinearRegression) over regParam {0, 0.01, 100} ×
   elasticNetParam {0, 0.5}, rmse; CrossValidator(RandomForestClassifier(10
   trees, 32 bins)) over maxDepth {4, 8}, 2 folds, on the first 65,536 rows;
   OneVsRest(LogisticRegression) on 10 classes beside the multinomial fit;
   Pipeline([PCA(k=16), LogisticRegression]) fitted, saved, loaded. Holds:
   the folds numpy's draw; the single pass against the loop (sub-models bit
   for bit, predictions equal but for rows within 1e-5 of p1 = 0.5);
   parallelism 3 bit for bit; card vs CPU: the same best index, avgMetrics
   within 1e-3; each fold's OLS candidate within ``ols_reference``'s band of
   an f64 fit of its rows, its rmse within 1e-5 of that fit's, regParam 100
   never chosen; the forests' combined metrics equal their own transforms'
   bit for bit; OneVsRest's raw columns its binary models' raw scores bit
   for bit, its accuracy within 0.05 of the multinomial's; the Pipeline's
   predictions after save and load bit for bit; each with a negative
   control. K1, K3, K5 (or K6) and K9 launch, no plain version runs on the
   card (the ``tuning`` path of their rows).

The last three lines are the card line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits 1
and prints no result.

    python3 chip_smoke.py --gather-only [--sweep]

is a probe: K7/K8's kernel phase alone on 131,072 rows (and, with
``--sweep``, each instance at a range of chunk sizes and grids), with the
host cost of the wrapper's steps; it prints no result line.

    python3 chip_smoke.py --knn-only [--sweep]

is a probe too: K4's kernel phase alone (its four main shapes, ragged
shapes and controls) on 1M rows made from ``--seed``, with the kernel's
registers, spills, resident blocks and SASS instruction counts and its
gates' verdicts (reported, not enforced); ``--sweep`` times other stage depths and item
splits, and a tight state that no tile passes (the product and the gate
without the insertion).

    python3 chip_smoke.py --kmeans-only [--sweep]

is a probe of K2 alike: its kernel phase alone on ``--rows`` rows, with
its attributes, SASS counts (``HGMMA``, ``FFMA``, ``UTMALDG``, the atomics)
and gates; ``--sweep`` times every row weight 0 beside every row weight 1
(an m = 0 row skips the atomics: the product, the argmin and the row walk
alone) and the other stage depths.

    python3 chip_smoke.py --logreg-only [--sweep]

is a probe of K3: at the route's five timed shapes, its class-tiled
instance's four, the cluster kernel's four, the shape the general kernel
keeps and the tile kernel's <1, 8> and <1, 16> instances,
each held with its controls and timed as the whole call, its first
kernel (the route: its two kernels, and its logits kernel alone) and its
second pass alone, for the routed kernel and, forced by its code, the
general kernel (so each kernel and the general kernel stand side by
side in one call), with registers, spills and resident blocks (the
cluster kernel: its geometry and the clusters the card holds at once),
then the ragged tile, route and cluster shapes; ``--sweep`` adds the
general kernel's gradient stage without its X re-read or its per-tile
partial write, and the cluster kernel without its gradient's reads of the
staged rows or its exchange, and at every other cluster size that takes
the shape. It prints no result line and exits 1 if a check failed.

    python3 chip_smoke.py --umap-only [--sweep]

is a probe of K10: its checks at its four shapes, then the two UMAP paths
with their card-vs-CPU fits; ``--sweep`` first times its STEP epilogue with
parts of its work knocked out. It prints no result line and exits 1 if a
check failed.

    python3 chip_smoke.py --ann-only

is a probe of the IVF slice: K2, K4 and K10 alone built, K2 at the
quantizer's shape, then the ann and umap_ivf paths, then K10 at the
umap_ivf path's two shapes. It prints no result line and exits 1 if a
check failed.

    python3 chip_smoke.py --traverse-only

is a probe of K9: its checks alone with random forests (no fits), at its
four timed shapes held bit for bit with their controls and timed (device
time apart from host time a call), the route gate, and the ragged shapes.
It prints no result line.

    python3 chip_smoke.py --linreg-only

is a probe of the LinearRegression slice: K1 at its two LinearRegression
shapes, then the three LinearRegression paths on ``--rows`` rows. It
prints no result line.

    python3 chip_smoke.py --stream-only

is a probe of the streamed path: K1, K3 and K2 alone built, the streamed
phase alone on ``--rows`` rows. It prints no result line.

    python3 chip_smoke.py --f64-only

is a probe of the float64 phase (q): K1, K3 and K2 alone built, the phase
alone on F64_ROWS rows made from ``--seed`` (fewer with a smaller
``--rows``). It prints no result line.

    python3 chip_smoke.py --tuning-only

is a probe of the tuning phase (r): K1, K3, K5/K6 and K9 alone built, the
phase alone on TUNING_ROWS rows made from ``--seed`` (fewer with a smaller
``--rows``). It prints no result line.

    python3 chip_smoke.py --wire-only

is a probe of the wire formats and checkpoint/resume: K1, K3 and K2 alone
built, phases (o) and (p) alone on STREAM_WIRE_ROWS rows made from
``--seed`` (fewer with a smaller ``--rows``). It prints no result line.

    python3 chip_smoke.py --hist-only [--sweep]

is a probe of K5 and K6: K5 at the GBT's level 7 and the bench forest's
level 12 on the forest rows, each timed as one whole K5-route level of the
builder and as K5 per node (held with its controls, its span kernel's
registers, spills and resident blocks), then the ragged K5 cases; K6 at
its three timed shapes, held and timed beside route B and its library
calls, and one whole wide-route level of the builder, then the ragged K6
cases; ``--sweep`` adds the GBT's levels 0 and 3, K5 per node with its
walk, row loads or write knocked out and at other span and stage sizes,
and K6 with the same knock-outs, at other stage sizes and with twice the
span partials' bound. It prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks: FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
# timed calls of K7/K8 and their library call: launch-sized, so many
SLEEP_CYCLES = 60_000_000  # the device wait ahead of them: ~30 ms at 1.98 GHz
GATHER_REPS = 200

E2E_D = 256
E2E_CENTRES = 1024
# the kNN and UMAP shapes of bench.py (KNN_QUERIES x KNN_ITEMS, UMAP_ROWS)
KNN_QUERIES = 131_072
KNN_ITEMS = 1_000_000
KNN_K = 16
UMAP_ROWS = 65_536
UMAP_NEIGHBORS = 15
# trustworthiness threshold of tests/test_umap.py, on a sample of this many rows
TRUST_MIN = 0.85
TRUST_ROWS = 4096
# rows of the UMAP fitted on the card and on the CPU
UMAP_SUBSET = 20_000
# the umap_cluster path: MNIST's shape (70,000 x 784) as 10 Gaussian blobs,
# UMAP(n_neighbors=30, min_dist=0.0, n_components=10): the setting of
# umap-learn's "Using UMAP for Clustering" guide, a 10-wide embedding for a
# clustering step; its first 10,000 rows also fitted on the card and the CPU
CLUSTER_ROWS = 70_000
CLUSTER_D = 784
CLUSTER_BLOBS = 10
CLUSTER_NEIGHBORS = 30
CLUSTER_MIN_DIST = 0.0
CLUSTER_COMPONENTS = 10
CLUSTER_SUBSET = 10_000
# bench.py's rf config (bench.py:652-728): 131,072 x 256, 50 trees, depth
# 13, 128 bins; the regressor and the 3,000-feature forest (the
# reference's benchmark width, rows cut from 1M) keep 8 trees
RF_ROWS = 131_072
RF_TREES = 50
RF_DEPTH = 13
RF_BINS = 128
RF_SMALL_TREES = 8
RF_WIDE_D = 3000
# the reference's RandomForest benchmark (BASELINE.md:16,26): 1,000,000 x
# 3,000, 50 trees, depth 13, 128 bins; rf_wide keeps its rows, features,
# bins and depth, and 8 trees; its nodes draw sqrt(3,000) = 55 features
RF_WIDE_ROWS = 1_000_000
RF_WIDE_K = 55
# the 3,000-feature forest fitted on the card and on the CPU
RF_WIDE_SUBSET_ROWS = 20_000
# the reference's RandomForestRegressor benchmark (BASELINE.md:27): 30
# trees, depth 6 (hop 1 only: k2 = 0), 128 bins; rf_regressor_ref fits it
# on the bench rows
RF_REF_REG_TREES = 30
RF_REF_REG_DEPTH = 6
# the forest fitted on the card and on the CPU
RF_SUBSET_ROWS = 20_000
RF_SUBSET_DEPTH = 10
RF_AGREE_MIN = 0.999
# bench.py's gbt config (bench.py:955-1137): binary logistic on the rf rows,
# 20 rounds, depth 8 (hop 1 of 7 levels, hop 2 of 1), 128 bins, all features
GBT_ROUNDS = 20
GBT_DEPTH = 8
# training accuracy floor of the GBT classifier: the label is a hyperplane
# through all 256 features, which 20 lr-0.1 rounds of axis-aligned depth-8
# trees fit to about 0.8 (a flipped near-tie moves it by about 0.01); the
# constant model scores 0.5
GBT_ACC_MIN = 0.75
# the GBT fitted on the card and on the CPU: gradient stats are real
# valued, so sums in other orders may move a near-tied split (RF's 99.9%
# rests on exact integer histograms)
GBT_SUBSET_ROUNDS = 10
GBT_AGREE_MIN = 0.995
# the multinomial LogisticRegression fitted on the card and on the CPU
LOGREG_CLASSES = 10
LOGREG10_AGREE_MIN = 0.995


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def device_host(torch, fn, reps: int):
    """(device ms per call, host µs per call) of ``fn`` over ``reps`` calls
    queued behind a device wait (``torch.cuda._sleep``, a spin kernel), so
    that the host runs ahead and the events around the calls time the
    device alone; the host clock times their enqueue, with no
    synchronisation inside. Fails if the enqueue outlasted the wait: the
    device would then have gone idle between calls, and the number would
    not be device-only."""
    fn()
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t = time.perf_counter()
    e0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    e1.record()
    h = time.perf_counter()
    for _ in range(reps):
        fn()
    t_end = time.perf_counter()
    e2.record()
    e2.synchronize()
    wait_ms = e0.elapsed_time(e1)
    check((t_end - t) * 1e3 < wait_ms,
          f"{reps} calls took {(t_end - t) * 1e3:.3f} ms to enqueue, longer than the {wait_ms:.3f} ms device wait")
    return e1.elapsed_time(e2) / reps, (t_end - h) * 1e6 / reps


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def median_device_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``reps`` calls, each timed by CUDA events
    around it, after one warm-up call, all queued behind a device wait
    (``torch.cuda._sleep``) so that the host runs ahead and each interval
    is the device's time for that call, not the wrapper's host path; the
    median drops a call that a host stall still reached. Unlike
    :func:`device_host` it does not fail when the enqueue outlasts the
    wait."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for i in range(reps):
        ev[i].record()
        fn()
    ev[reps].record()
    ev[reps].synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]))


def make_data(torch, n_rows: int, n_alloc: int, seed: int, dev):
    """(X (n_alloc, 256) on the card with rows >= n_rows zero, labels (n_rows,)).

    Gaussian blobs around 1024 centres whose coordinates shrink
    geometrically (so the leading principal directions are separated), plus
    unit noise; binary labels from a random hyperplane through the median."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scales = 4.0 * 0.9 ** torch.arange(E2E_D, device=dev, dtype=torch.float32)
    centres = torch.randn(E2E_CENTRES, E2E_D, generator=g, device=dev) * scales
    X = torch.zeros((n_alloc, E2E_D), dtype=torch.float32, device=dev)
    step = 1 << 20
    for lo in range(0, n_rows, step):
        hi = min(lo + step, n_rows)
        lab = torch.randint(0, E2E_CENTRES, (hi - lo,), generator=g, device=dev)
        X[lo:hi] = torch.randn(hi - lo, E2E_D, generator=g, device=dev) + centres[lab]
    w = torch.randn(E2E_D, generator=g, device=dev)
    z = X[:n_rows] @ w
    y = (z > z.median()).to(torch.float32)
    return X, y


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Each f32 kernel output entry is held against the plain version evaluated
# in f64 on the same inputs (upcast), entry by entry:
#     |out - ref| <= u * (TOL_TERMS * T + TOL_WALK * sqrt(n) * |ref|) + slack
# with u the f32 unit roundoff and T the sum of the absolute values of the
# terms the entry adds up (and of the rounding of what feeds them). The first
# part covers the rounding of each term and the accumulation of terms that
# cancel; the second the accumulation of terms that drift one way, as a
# random walk over at most n additions (any summation order, atomics
# included). A tolerance scaled by each entry's own terms keeps the small
# entries (the noise dimensions of the data) as tightly checked as the large.
U32 = 2.0 ** -24
# the least normal f32
F32_TINY = 2.0 ** -126
TOL_TERMS = 8.0
TOL_WALK = 4.0
# K2 score rounding band: two f32 scores within TAU_UNITS * u * sqrt(d) *
# (||x||² + 2 max ||c||²) may order either way (a length-d dot product
# rounds as a random walk)
TAU_UNITS = 4.0
REF_CHUNK = 1 << 20


def held(torch, out, ref, T, n, slack=None, terms=TOL_TERMS, walk=None):
    """Per-entry comparison of ``out`` with the f64 ``ref``; returns the
    largest absolute error and the largest rounding error over its
    tolerance (the error beyond ``slack``, the part a known cause such as a
    near tie explains). Holds when the ratio is at most 1. ``terms`` and
    ``walk`` (TOL_WALK·√n when None) weigh the two parts of the band (a
    streamed pass: more terms for the f32 sum of its chunk partials, the
    walk over one chunk's rows)."""
    ref = ref.to(torch.float64)
    err = (out.to(torch.float64) - ref).abs()
    walk = TOL_WALK * (n ** 0.5) if walk is None else walk
    tol = U32 * (terms * T + walk * ref.abs())
    excess = err if slack is None else torch.clamp(err - slack, min=0.0)
    ratio = torch.where(excess > 0, excess / tol, torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def negative_controls(torch, cases, ref, T, n, slack=None):
    """The same check on deliberately wrong outputs ``{what: bad}``: each
    must fail. Also says whether a tolerance of 1e-4 of the largest entry
    (the check this one replaced) would have caught it."""
    old_tol = 1e-4 * float(ref.abs().max())
    out = []
    for what, bad in cases.items():
        err, ratio = held(torch, bad, ref, T, n, slack)
        check(ratio > 1.0, f"the check does not catch a wrong result ({what}): err/tol {ratio:.3g}")
        out.append({"control": what, "max_abs_err": err, "err_over_tol": ratio,
                    "caught_by_1e-4_of_max": err > old_tol})
    return out


# rows that the subtle controls lose: one of this many row ranges
CONTROL_SPLIT = 64


def gram_reference(torch, lin, X, m, mu):
    """K1's plain version in f64, in row chunks, with the absolute sums T."""
    d, f64 = X.shape[1], torch.float64
    G = torch.zeros((d, d), dtype=f64, device=X.device)
    TG = torch.zeros_like(G)
    s = torch.zeros((d,), dtype=f64, device=X.device)
    Ts = torch.zeros_like(s)
    mu64 = mu.to(f64)
    step = max(1, min(REF_CHUNK, REF_CHUNK * E2E_D // d))  # ~2 GB of f64 rows a chunk
    for lo in range(0, X.shape[0], step):
        x, mm = X[lo:lo + step].to(f64), m[lo:lo + step].to(f64)
        g, sc = lin.shifted_gram_plain(x, mm, mu64)
        a = ((x - mu64) * mm[:, None]).abs()
        G += g
        s += sc
        TG += a.T @ a
        Ts += a.sum(dim=0)
    return G, s, TG, Ts


def check_shifted_gram(torch, lin, X, m, reps, control=False):
    n, d = X.shape
    mu = X[:: max(1, n // 65536)][:65536].mean(dim=0).contiguous()
    G, s = lin.shifted_gram(X, m, mu)
    Gr, sr, TG, Ts = gram_reference(torch, lin, X, m, mu)
    err_G, r_G = held(torch, G, Gr, TG, n)
    err_s, r_s = held(torch, s, sr, Ts, n)
    check(r_G <= 1.0 and r_s <= 1.0,
          f"shifted_gram {n}x{d}: |dG|/tol {r_G:.3g} or |ds|/tol {r_s:.3g} above 1")
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    T, n_up, nsplit, rows = lin._gram_geometry(n, d, sms, lin._gram_blocks_per_sm())
    out = {"n": n, "d": d, "max_abs_err": err_G, "err_over_tol": r_G, "s_err": err_s,
           "s_err_over_tol": r_s, "col_tiles": T, "upper_tiles": n_up, "splits": nsplit, "split_rows": rows,
           "partial_bytes": 4 * nsplit * n_up * (lin._GRAM_TILE + 1) * lin._GRAM_TILE}
    if control:  # a kernel that loses an output tile, one row range in a tile,
        # or mirrors a diagonal tile's skipped lower-left quadrant wrongly
        tile = G.clone()
        tile[128:, :128] = 0.0
        tile[:128, 128:] = 0.0
        mirror = G.clone()
        mirror[64:128, :64] = 0.0
        L = n // CONTROL_SPLIT
        lost = lin.shifted_gram_plain(X[:L], m[:L], mu)[0]
        lost[:128, :] = 0.0
        lost[:, :128] = 0.0
        lost.fill_diagonal_(0.0)
        out["controls"] = negative_controls(torch, {
            "off-diagonal 128x128 tile zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in G[128:, 128:] off the diagonal": G - lost,
            "diagonal tile's lower-left 64x64 quadrant zeroed (a wrong mirror)": mirror,
        }, Gr, TG, n)
    if reps:
        Xc = (X - mu) * m[:, None]
        out["ms"] = cuda_ms(torch, lambda: lin.shifted_gram(X, m, mu), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: lin.shifted_gram_plain(X, m, mu), reps)
        out["library_ms"] = cuda_ms(torch, lambda: torch.matmul(Xc.T, Xc), reps)
        out["ms_over_library"] = out["ms"] / out["library_ms"]
        del Xc
        nbytes = 4.0 * (n * d + n + d + d * d + d)
        flops = float(n) * d * (d + 1) + 3.0 * n * d  # symmetric G + shift/mask/sum
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
    return out


def phase_gram_shapes(torch, lin, X_pca, n_rows, reps, g):
    """K1 at LinearRegression's shapes, with the controls: (a) row scales
    m = √w, w uniform in [0.1, 2], padding rows 0, on the padded 12M × 256
    rows; (b) 3,000 wide, the linreg_wide fit's 1,024,000 × 3,000, a
    zero-copy view of the 12M × 256 rows."""
    dev = X_pca.device
    res = {}
    m = torch.sqrt(torch.rand(X_pca.shape[0], generator=g, device=dev) * 1.9 + 0.1)
    m[n_rows:] = 0.0
    res["shifted_gram_sqrt_w"] = r = check_shifted_gram(torch, lin, X_pca, m, reps, control=True)
    emit({"phase": "kernels", "kernel": "shifted_gram", "shape": "shifted_gram_sqrt_w", **r})
    del m
    n_w = n_rows * E2E_D // LINREG_WIDE_D
    if n_w:
        Xw = X_pca[:n_rows].reshape(-1)[:n_w * LINREG_WIDE_D].view(n_w, LINREG_WIDE_D)
        res["shifted_gram_wide"] = r = check_shifted_gram(torch, lin, Xw, torch.ones(n_w, device=dev), reps,
                                                          control=True)
        emit({"phase": "kernels", "kernel": "shifted_gram", "shape": "shifted_gram_wide", **r})
        del Xw
    torch.cuda.empty_cache()
    return res


def lloyd_reference(torch, kk, X, m, C, chunk=1 << 17, weighted=False):
    """K2's plain version in f64, in row chunks, with the absolute sums T
    and the near ties: rows whose second (or third) best f64 score lies
    within the f32 rounding band of the best, which the kernel may assign
    to any of those centres. For each centre, ``near`` counts such rows
    with the centre in their band and ``slack`` adds up their ``m·|x|``.
    ``A`` adds up the absolute values of each chunk's sums (the band of a
    streamed pass whose chunks are these). ``weighted``: a row counts m
    times in ``counts`` and ``near`` (m a row multiplicity: the rows of a
    streamed pass that repeats rows), not once where m > 0 as in K2."""
    k, d = C.shape
    f64, dev = torch.float64, X.device
    C64 = C.to(f64)
    C64_abs = C64.abs()
    c_sq = (C64 * C64).sum(dim=1)
    c_sq_max = float(c_sq.max())
    r = {"sums": torch.zeros((k, d), dtype=f64, device=dev),
         "counts": torch.zeros((k,), dtype=torch.int64, device=dev),
         "cost": torch.zeros((), dtype=f64, device=dev),
         "T": torch.zeros((k, d), dtype=f64, device=dev),
         "T_cost": torch.zeros((), dtype=f64, device=dev),
         "near": torch.zeros((k,), dtype=torch.int64, device=dev),
         "slack": torch.zeros((k, d), dtype=f64, device=dev),
         "slack_cost": torch.zeros((), dtype=f64, device=dev),
         "A": torch.zeros((k, d), dtype=f64, device=dev),
         "near_rows": 0}
    for lo in range(0, X.shape[0], chunk):
        x, mm = X[lo:lo + chunk].to(f64), m[lo:lo + chunk].to(f64)
        s_, c_, cost_ = kk.lloyd_step_plain(x, mm, C64)
        r["sums"] += s_
        r["A"] += s_.abs()
        r["cost"] += cost_
        sc = c_sq[None, :] - 2.0 * (x @ C64.T)
        _, a = torch.min(sc, dim=1)
        r["counts"] += (torch.bincount(a, weights=mm, minlength=k).round().to(torch.int64) if weighted
                        else c_.to(torch.int64))
        ax = x.abs() * mm[:, None]
        r["T"].index_add_(0, a, ax)
        r["T_cost"] += (mm * ((x.abs() + C64_abs[a]) ** 2).sum(dim=1)).sum()
        if k < 2:
            continue
        top = torch.topk(sc, min(k, 3), dim=1, largest=False)
        tau = TAU_UNITS * U32 * d ** 0.5 * ((x * x).sum(dim=1) + 2.0 * c_sq_max)
        near_row = ((top.values[:, 1] - top.values[:, 0]) < tau) & (mm > 0)
        band = ((top.values - top.values[:, :1]) < tau[:, None]) & near_row[:, None]
        for col in range(top.indices.shape[1]):
            sel = band[:, col]
            if weighted:
                r["near"] += torch.bincount(top.indices[sel, col], weights=mm[sel], minlength=k).round().to(
                    torch.int64)
            else:
                r["near"] += torch.bincount(top.indices[sel, col], minlength=k)
            r["slack"].index_add_(0, top.indices[sel, col], ax[sel])
        r["slack_cost"] += (tau * mm)[near_row].sum()
        r["near_rows"] += int(mm[near_row].sum()) if weighted else int(near_row.sum())
    return r


def lloyd_verdict(torch, sums, counts, cost, ref, n):
    """K2's rule against the f64 reference: a row may change centre only
    across a near tie, and the sums and cost within ``held``'s band beyond
    the near ties' slack. Returns (counts within the near ties, |dcount|,
    max |dsums|, |dsums|/tol, |dcost|/tol)."""
    dcount = (counts.to(torch.int64) - ref["counts"]).abs()
    counts_ok = bool((dcount <= ref["near"]).all())
    err, r_sums = held(torch, sums, ref["sums"], ref["T"], n, ref["slack"])
    _, r_cost = held(torch, cost, ref["cost"], ref["T_cost"], n, ref["slack_cost"])
    return counts_ok, dcount, err, r_sums, r_cost


def check_lloyd_step(torch, kk, X, m, C, reps, control=False, timer=None):
    """K2 on (X, m, C) held against ``lloyd_reference`` by ``lloyd_verdict``
    (with its negative controls where ``control``), and timed over ``reps``
    calls by ``timer`` (``cuda_ms`` when None) beside its plain version and
    one matmul + argmin + ``index_add_``, with its bound."""
    timer = cuda_ms if timer is None else timer
    n, d = X.shape
    k = C.shape[0]
    sums, counts, cost = kk.lloyd_step(X, m, C)
    ref = lloyd_reference(torch, kk, X, m, C)
    counts_ok, dcount, err, r_sums, r_cost = lloyd_verdict(torch, sums, counts, cost, ref, n)
    check(counts_ok and r_sums <= 1.0 and r_cost <= 1.0,
          f"lloyd_step {n}x{d} k={k}: counts beyond the near ties ({counts_ok}), "
          f"|dsums|/tol {r_sums:.3g} or |dcost|/tol {r_cost:.3g} above 1")
    out = {"n": n, "d": d, "k": k, "max_abs_err": err, "err_over_tol": r_sums,
           "count_changes": int(dcount.sum()), "near_tie_rows": ref["near_rows"],
           "cost_rel_err": abs(float(cost) - float(ref["cost"])) / float(ref["cost"]),
           "cost_err_over_tol": r_cost}
    if control:  # a kernel that loses the second feature tile, or one row range in it
        tile = sums.clone()
        tile[:, 128:] = 0.0
        L = n // CONTROL_SPLIT
        lost = sums.clone()
        lost[:, 128:] -= kk.lloyd_step_plain(X[:L], m[:L], C)[0][:, 128:]
        out["controls"] = negative_controls(torch, {
            "sums[:, 128:] zeroed": tile,
            f"first 1/{CONTROL_SPLIT} of rows lost in sums[:, 128:]": lost,
        }, ref["sums"], ref["T"], n, ref["slack"])
        # one-pass TF32 scores (the plain version with TF32 matmuls) must
        # fail the rule that the kernel's 3xTF32 scores keep to
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            s32, c32, cost32 = kk.lloyd_step_plain(X, m, C)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        ok32, dc32, _, rs32, rc32 = lloyd_verdict(torch, s32, c32, cost32, ref, n)
        check(not (ok32 and rs32 <= 1.0 and rc32 <= 1.0), "the K2 check does not catch one-pass TF32 scores")
        out["controls"].append({"control": "plain version with one-pass TF32 matmuls",
                                "counts_within_near_ties": ok32, "count_changes": int(dc32.sum()),
                                "err_over_tol": rs32, "cost_err_over_tol": rc32})
        del s32, c32
    del ref
    if reps:
        c_sq = (C * C).sum(dim=1)

        def library():  # score product, argmin, index_add_, 1M rows a call
            acc = torch.zeros_like(sums)
            for lo in range(0, n, 1 << 20):
                xs = X[lo:lo + (1 << 20)]
                a = torch.argmin(c_sq[None, :] - 2.0 * (xs @ C.T), dim=1)
                acc.index_add_(0, a, xs * m[lo:lo + (1 << 20), None])
            return acc

        out["ms"] = timer(torch, lambda: kk.lloyd_step(X, m, C), reps)
        out["plain_ms"] = timer(torch, lambda: kk.lloyd_step_plain(X, m, C), reps)
        out["library_ms"] = timer(torch, library, reps)
        nbytes = 4.0 * (n * d + n + k * d + k * d + k + 1)
        # the score product runs on the tensor cores in 3xTF32: three TF32
        # products per (row, centre, feature), at the dense TF32 rate; the
        # sums, ||x||² and the argmin on the CUDA cores are below 1% of it
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 3.0 * 2.0 * n * k * d, PEAK_TF32_FLOPS)
        # the same work as f32 FMA on the CUDA cores
        flops = 2.0 * n * k * d + 2.0 * n * d + 3.0 * n * k  # scores, sums+||x||², argmin
        out["bound_f32_ms"] = bound_ms(nbytes, flops)[0]
    return out


def logreg_reference(torch, lk, X, y, m, A, b, multinomial):
    """K3's plain version in f64, in row chunks, with the absolute sums T.
    The f32 logits are off by at most about u·S (S = the row's largest
    Σ|x·a| + |b|), which moves a probability p by at most 2·u·S·p (its
    logit and the softmax's sum; binomial: 2·u·S·p·(1 - p), the sigmoid's
    slope, with a factor 2 for its change over u·S while u·S < ln 2) and
    a row's loss by 2·u·S; the binomial form's f32 sigmoid 1 / (1 + e^-z)
    is itself off by a few ulps of p, which its slope does not bound where
    p nears 1. Each (row, class) weighs m·(|R| + 2·S·p) (the binomial form
    m·(|R| + 2·S·p·(1 - p) + p)) in gA's and gb's T, each row m·2·S in the
    loss's. Per class, so at many classes a class's band
    follows its own residuals, not K times a row's (a p that f32 cannot
    hold, below its least normal number, adds F32_TINY / u)."""
    d, K, f64 = X.shape[1], A.shape[0], torch.float64
    chunk = max(1, REF_CHUNK * E2E_D // max(d, K))  # f64 chunks of at most 2 GB
    A64, b64 = A.to(f64), b.to(f64)
    loss = torch.zeros((), dtype=f64, device=X.device)
    gA = torch.zeros((K, d), dtype=f64, device=X.device)
    gb = torch.zeros((K,), dtype=f64, device=X.device)
    T_gA = torch.zeros((K, d), dtype=f64, device=X.device)
    T_b = torch.zeros((K,), dtype=f64, device=X.device)
    T_z = torch.zeros((), dtype=f64, device=X.device)
    for lo in range(0, X.shape[0], chunk):
        x, yy, mm = X[lo:lo + chunk].to(f64), y[lo:lo + chunk].to(f64), m[lo:lo + chunk].to(f64)
        l_, gA_, gb_ = lk.logreg_loss_grad_plain(x, yy, mm, A64, b64, multinomial)
        loss += l_
        gA += gA_
        gb += gb_
        S = (x.abs() @ A64.abs().T + b64.abs()[None, :]).max(dim=1).values
        z = x @ A64.T + b64[None, :]
        if multinomial:
            p = torch.softmax(z, dim=1)
            R = p - torch.nn.functional.one_hot(yy.long(), K).to(f64)
            dp = p
        else:
            p = torch.sigmoid(z)
            R = p - yy[:, None]
            dp = p * (1.0 - p)
        w = mm[:, None] * (R.abs() + 2.0 * S[:, None] * dp + F32_TINY / U32)
        if not multinomial:  # the f32 sigmoid's own rounding
            w += mm[:, None] * p
        del z, p, R, dp
        T_gA += w.T @ x.abs()
        T_b += w.sum(dim=0)
        T_z += (2.0 * mm * S).sum()
    return loss, gA, gb, T_gA, T_b, loss.abs() + T_z


def k3_variant(lk, d, K, multinomial, aligned=True) -> str:
    """Which kernel of ``csrc/logreg_loss_grad.cu`` the wrapper launches."""
    code = lk._k3_variant(d, K, multinomial, aligned)
    if code == 0:
        return "general"
    if code >= lk._CLUSTER:
        return f"cluster(IPT={code - lk._CLUSTER})"
    if code >= 3000:
        return ("route(tiled, N=128)" if code == lk._ROUTE_TILED else "route(N=2x128)" if code == 3256
                else f"route(N={code - 3000})")
    if code >= 1000:
        return f"tile(KG={1 if code < 2000 else 4}, IPT={code % 1000})"
    return f"rows(NV={code // 10}, KR=1)" if code < 100 else f"mrows(NV={code // 100}, K={code % 100})"


def check_logreg(torch, lk, X, y, m, K, reps, seed, control=False, strict=False, a_std=0.05, n_valid=None):
    """K3 at one shape against its f64 plain version (``logreg_reference``,
    ``held``), naming the kernel that ran it. ``control``: the negative
    controls the band must catch (a zeroed feature tile, lost rows, the
    class-tiled instance's unrescaled merge) and, where ``strict`` (the
    timed shapes and the cluster kernel's ragged ones), the route's
    products in one-pass TF32 and the cluster kernel's last rank dropped
    from every logit, else reported. A's entries are N(0, ``a_std``²).
    ``reps``: timed (median device time) beside its plain version and one
    autograd call (the cluster kernel: and the general kernel forced by
    its code), with its bound. ``n_valid``: a streamed chunk's real rows;
    the multinomial labels past them are 0, as the chunk's padding has
    them."""
    n, d = X.shape
    g = torch.Generator(device=X.device)
    g.manual_seed(seed)
    A = (torch.randn(K, d, generator=g, device=X.device) * a_std).contiguous()
    b = torch.randn(K, generator=g, device=X.device) * 0.1
    multinomial = K > 1
    yk = y if not multinomial else torch.randint(0, K, (n,), generator=g, device=X.device).float()
    if multinomial and n_valid is not None:
        yk[n_valid:] = 0.0
    loss, gA, gb = lk.logreg_loss_grad(X, yk, m, A, b, multinomial)
    lr, gAr, gbr, T_gA, T_gb, T_loss = logreg_reference(torch, lk, X, yk, m, A, b, multinomial)
    err, r_gA = held(torch, gA, gAr, T_gA, n)
    gb_err, r_gb = held(torch, gb, gbr, T_gb, n)
    _, r_loss = held(torch, loss, lr, T_loss, n)
    check(r_gA <= 1.0 and r_gb <= 1.0 and r_loss <= 1.0,
          f"logreg_loss_grad {n}x{d} K={K}: |dgA|/tol {r_gA:.3g}, |dgb|/tol {r_gb:.3g} "
          f"or |dloss|/tol {r_loss:.3g} above 1")
    aligned = X.data_ptr() % 16 == 0 and A.data_ptr() % 16 == 0
    variant = k3_variant(lk, d, K, multinomial, aligned)
    out = {"n": n, "d": d, "K": K, "variant": variant,
           "max_abs_err": err, "err_over_tol": r_gA,
           "loss_rel_err": abs(float(loss) - float(lr)) / abs(float(lr)),
           "loss_err_over_tol": r_loss, "gb_err": gb_err, "gb_err_over_tol": r_gb}
    if control:  # a kernel that loses the second feature tile, or one row range in it
        tile = gA.clone()
        tile[:, 128:] = 0.0
        cases = {"gA[:, 128:] zeroed": tile}
        L = n // CONTROL_SPLIT
        if L:
            lost = gA.clone()
            lost[:, 128:] -= lk.logreg_loss_grad_plain(X[:L], yk[:L], m[:L], A, b, multinomial)[1][:, 128:]
            cases[f"first 1/{CONTROL_SPLIT} of rows lost in gA[:, 128:]"] = lost
        if variant.startswith("route(tiled"):  # the class tiles merged without rescaling the sum
            cases["class tiles merged unrescaled"] = lk._logreg_run(X, yk, m, A, b, True, lk._ROUTE_TILED, 32)[1]
        extra = {}
        if variant.startswith("cluster"):  # the last rank's partial left out of every logit
            code = lk._k3_variant(d, K, multinomial, aligned)
            extra["dropped_rank"] = lk._logreg_run(X, yk, m, A, b, False, code, 128)[1]
        if variant.startswith("route"):  # both products in one-pass TF32 (hi * hi' alone)
            from spark_rapids_ml_tpu_torch.ops.knn_kernels import tf32_round

            Xt = tf32_round(X)
            extra["one_pass_tf32"] = logreg_reference(torch, lk, Xt, yk, m, tf32_round(A), b, multinomial)[1]
            del Xt
        names = {"dropped_rank": "last cluster rank's partial dropped", "one_pass_tf32": "one-pass TF32 products"}
        for what, bad in extra.items():
            if strict:
                cases[names[what]] = bad
            else:
                out[f"{what}_err_over_tol"] = held(torch, bad, gAr, T_gA, n)[1]
        del extra
        out["controls"] = negative_controls(torch, cases, gAr, T_gA, n)
    if reps:
        def library():  # autograd of the plain loss
            Ar = A.detach().requires_grad_(True)
            br = b.detach().requires_grad_(True)
            z = X @ Ar.T + br[None, :]
            if multinomial:
                ll = torch.logsumexp(z, 1) - z.gather(1, yk.long()[:, None])[:, 0]
            else:
                ll = torch.nn.functional.softplus(z[:, 0]) - yk * z[:, 0]
            return torch.autograd.grad((ll * m).sum(), (Ar, br))

        # device time, the median of the calls: a mean over calls timed by
        # events around them includes the wrapper's host path, and once read
        # a host stall as a slow cluster kernel at 20,000 x 20,000
        out["ms"] = median_device_ms(torch, lambda: lk.logreg_loss_grad(X, yk, m, A, b, multinomial), reps)
        if variant.startswith("cluster"):  # the kernel it replaced at these widths, forced by its code
            out["general_ms"] = median_device_ms(torch, lambda: lk._logreg_run(X, yk, m, A, b, False, 0), reps)
        out["plain_ms"] = median_device_ms(
            torch, lambda: lk.logreg_loss_grad_plain(X, yk, m, A, b, multinomial), reps)
        out["library_ms"] = median_device_ms(torch, library, reps)
        nbytes = 4.0 * (n * d + 2 * n + 2 * K * d + 2 * K + 1)
        flops = 4.0 * n * K * d + 10.0 * n * K  # logits + R^T x, loss/residual
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
        if variant.startswith("route"):  # its two products in 3xTF32 on the tensor cores
            out["bound_f32_ms"] = out["bound_ms"]
            out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 3.0 * 4.0 * n * K * d, PEAK_TF32_FLOPS)
    return out


def knn_reference(torch, kn, Xq, Xi, csq, ids, k):
    """K4's plain version in f64 at k + 1: (d2 (nq, k+1) in (distance, id)
    order, ids, tau). tau bounds the f32 error of each entry's distance:
    TAU_UNITS·u·√d·(‖xq‖² + 2 Σ|xq·xi| + ‖xi‖²), the K2 band with the
    entry's own terms."""
    f64 = torch.float64
    Xq64 = Xq.to(f64)
    state = (torch.full((Xq.shape[0], k + 1), float("inf"), dtype=f64, device=Xq.device),
             torch.full((Xq.shape[0], k + 1), -1, dtype=torch.int32, device=Xq.device))
    csq64 = (Xi.to(f64) ** 2).sum(dim=1).masked_fill(~torch.isfinite(csq), float("inf"))
    s, i = kn.knn_topk_pass_plain(Xq64, Xi.to(f64), csq64, ids, *state)
    xsq = (Xq64 * Xq64).sum(dim=1)
    xi = Xi[i.long().clamp(min=0)].to(f64)  # (nq, k+1, d)
    T = xsq[:, None] + 2.0 * (Xq64.abs()[:, None, :] * xi.abs()).sum(dim=2) + (xi * xi).sum(dim=2)
    tau = TAU_UNITS * U32 * Xq.shape[1] ** 0.5 * T
    return s + xsq[:, None], i, tau


def knn_held(torch, d2, ids, ref_d2, ref_ids, tau):
    """Kernel K4's (d2, ids) (nq, k) against the f64 reference at k + 1.
    Each distance within the row's largest tau of the reference at the
    same position (order statistics move by at most the largest error); the
    id sets equal, except on rows whose reference k-th and (k+1)-th
    distances lie within 2·tau of each other (a near tie at the boundary,
    which f32 may break either way). Returns (max abs err, worst err/tau,
    rows whose ids differ, near-tie rows, rows whose ids differ outside the
    band)."""
    k = d2.shape[1]
    band = tau.max(dim=1).values
    err = (d2.to(torch.float64) - ref_d2[:, :k]).abs()
    ratio = float((err / band[:, None]).max())
    same = (ids.sort(dim=1).values == ref_ids[:, :k].sort(dim=1).values).all(dim=1)
    near = (ref_d2[:, k] - ref_d2[:, k - 1]) < 2.0 * band
    return float(err.max()), ratio, int((~same).sum()), int(near.sum()), int((~same & ~near).sum())


def check_knn_topk(torch, kn, Xq, Xi, mask, k, sample=None, reps=0, split=None, control=False):
    """K4 on (Xq, Xi) against its f64 plain version on the ``sample`` query
    rows (all rows when None). ``split`` folds the items in two passes,
    the second starting from the first's state."""
    nq, d = Xq.shape
    ni = Xi.shape[0]
    dev = Xq.device
    ids = torch.arange(ni, dtype=torch.int32, device=dev)
    csq = (Xi * Xi).sum(dim=1).masked_fill(mask <= 0, float("inf"))
    state = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))
    if split:
        state = kn.knn_topk_pass(Xq, Xi[:split], csq[:split], ids[:split], *state)
        topd, topi = kn.knn_topk_pass(Xq, Xi[split:], csq[split:], ids[split:], *state)
    else:
        topd, topi = kn.knn_topk_pass(Xq, Xi, csq, ids, *state)
    torch.cuda.synchronize()
    rows = torch.arange(nq, device=dev) if sample is None else sample
    xsq = (Xq[rows] * Xq[rows]).sum(dim=1)
    d2 = topd[rows] + xsq[:, None]
    ref_d2, ref_ids, tau = knn_reference(torch, kn, Xq[rows], Xi, csq, ids, k)
    err, ratio, differ, near, bad = knn_held(torch, d2, topi[rows], ref_d2, ref_ids, tau)
    masked_hit = int((~(mask[topi[rows].long().clamp(min=0)] > 0)).sum())
    check(ratio <= 1.0 and bad == 0 and masked_hit == 0,
          f"knn_topk {nq}x{ni}x{d} k={k}: |dd2|/tau {ratio:.3g}, {bad} rows with other ids "
          f"outside the near-tie band, {masked_hit} masked items selected")
    out = {"nq": nq, "ni": ni, "d": d, "k": k, "rows_checked": len(rows), "max_abs_err": err,
           "err_over_tol": ratio, "rows_other_ids": differ, "near_tie_rows": near,
           "masked_items": int((mask <= 0).sum()), "split": split}
    if control:  # the ids of one query tile shifted by one
        bad_ids = topi[rows].clone()
        bad_ids[:128] += 1
        b = knn_held(torch, d2, bad_ids, ref_d2, ref_ids, tau)
        check(b[4] > 0, "the K4 check does not catch one query tile's ids shifted")
        # one-pass TF32 scores (the plain version with TF32 matmuls) must
        # fall outside the band that the kernel's 3xTF32 scores keep to
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            st = (torch.full((len(rows), k), float("inf"), device=dev),
                  torch.full((len(rows), k), -1, dtype=torch.int32, device=dev))
            td32, ti32 = kn.knn_topk_pass_plain(Xq[rows], Xi, csq, ids, *st)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        c = knn_held(torch, td32 + xsq[:, None], ti32, ref_d2, ref_ids, tau)
        check(c[1] > 1.0 or c[4] > 0, "the K4 check does not catch one-pass TF32 scores")
        out["controls"] = [{"control": "ids of query rows 0..127 shifted by one",
                            "rows_other_ids_outside_band": b[4]},
                           {"control": "plain version with one-pass TF32 matmuls", "err_over_tol": c[1],
                            "rows_other_ids_outside_band": c[4]}]
    del ref_d2, ref_ids, tau
    if reps:
        st0 = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))

        def library():  # chunked addmm + torch.topk (ties in any order)
            outs = []
            for lo in range(0, nq, 4096):
                bd = None
                for jo in range(0, ni, 32768):
                    s = torch.addmm(csq[None, jo:jo + 32768], Xq[lo:lo + 4096], Xi[jo:jo + 32768].T,
                                    alpha=-2.0)
                    v, j = torch.topk(s, k, dim=1, largest=False)
                    j = j + jo
                    if bd is not None:
                        v, sel = torch.topk(torch.cat([bd, v], 1), k, dim=1, largest=False)
                        j = torch.cat([bi, j], 1).gather(1, sel)
                    bd, bi = v, j
                outs.append(bi)
            return outs

        out["ms"] = cuda_ms(torch, lambda: kn.knn_topk_pass(Xq, Xi, csq, ids, *st0), reps)
        out["plain_ms"] = cuda_ms(torch, lambda: kn.knn_topk_pass_plain(Xq, Xi, csq, ids, *st0), reps)
        out["library_ms"] = cuda_ms(torch, library, reps)
        nbytes = 4.0 * (nq * d + ni * d + 2 * ni + 4 * nq * k)  # Xq, Xi, csq, ids, state in + out
        # the products run on the tensor cores in 3xTF32: three TF32
        # products per operand pair, at the dense TF32 rate
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, 3.0 * 2.0 * nq * ni * d, PEAK_TF32_FLOPS)
        # the same work as f32 FMA on the CUDA cores
        out["bound_f32_ms"] = bound_ms(nbytes, 2.0 * nq * ni * d + 2.0 * nq * ni)[0]
    g = kn.knn_geometry(nq, ni, d, k)
    out.update(BM=g.bm, S=g.splits, stages=g.stages, slab=kn.K4_SLAB, blocks=g.blocks)
    return out


# K10: each term passes through a powf (a few ulps), a division or two and
# the rounding of diff and d2, so its f32 error is held at TOL_TERMS_SGD·u
# of its size rather than TOL_TERMS
TOL_TERMS_SGD = 32.0
# the parent kernel (one warp a row, lanes over its slots) at the fit and
# transform shapes: scripts/umap_epoch.py on the checkout before K10's
# redesign, mean of 50 (NVIDIA H100 80GB HBM3, 700.00 W); the redesign
# must beat both
K10_PARENT_MS = {"fit": 0.11340991973876953, "transform": 0.07890111923217774}
# the K10 checks' epoch step (the first epoch's learning rate)
K10_ALPHA = 1.0


def sgd_terms_abs(torch, uk, src, h, tails, p, perm, offs, u, a, b, gamma, scale):
    """Σ|term| per (row, component) of one K10 epoch, in f64 over the
    active slots: the T of the K10 band for the per-row sums."""
    R, K = tails.shape
    r, k = torch.nonzero(u < p, as_tuple=True)
    diff = h[r] - src[tails[r, k].long()]
    d2 = (diff * diff).sum(dim=1)
    ac = torch.where(d2 > 0, (2.0 * a * b * d2 ** (b - 1.0)) / (a * d2 ** b + 1.0), 0.0)
    T = torch.clamp((ac[:, None] * diff).abs(), max=4.0) * scale
    diff_n = h[r][:, None, :] - src[uk.negative_ids(perm, offs, R, K, r, k)]
    d2n = (diff_n * diff_n).sum(dim=2)
    rc = torch.where(d2n > 0, (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0)), 0.0)
    T = T + torch.clamp((rc[..., None] * diff_n).abs(), max=4.0).sum(dim=1)
    return torch.zeros((R, src.shape[1]), dtype=src.dtype, device=src.device).index_add_(0, r, T)


def k10_ratio(torch, out, ref, tol) -> float:
    err = (out.to(torch.float64) - ref).abs()
    return float(torch.where(err > 0, err / tol, torch.zeros_like(err)).max())


def k10_rows_band(torch, uk, src, h, tails, p, perm, offs, u, a, b, scale):
    """(ref, T, tol) of the ROWS epilogue: its f64 plain version on the
    same inputs and the band u·(TOL_TERMS_SGD·T + TOL_WALK·√n·|ref|), n
    the row's K·(1 + neg) terms."""
    f64 = torch.float64
    args = (src.to(f64), h.to(f64), tails, p.to(f64), perm, offs, u.to(f64))
    ref = uk.sgd_epoch_rows_plain(*args, a, b, 1.0, scale)
    T = sgd_terms_abs(torch, uk, *args, a, b, 1.0, scale)
    n_terms = tails.shape[1] * (1 + offs.shape[0])
    return ref, T, U32 * (TOL_TERMS_SGD * T + TOL_WALK * n_terms ** 0.5 * ref.abs())


def k10_step_band(torch, emb, row_off, rows_ref, T, n_terms_row, alpha):
    """(next_ref, upd_ref, tol) of the STEP epilogue from the f64 per-row
    sums and term sizes: each head's sums added up, its band the sum of its
    rows' (√ of all its terms), times alpha, plus the rounding of the step."""
    emb64 = emb.to(torch.float64)
    counts = row_off.diff()
    live = int(row_off[-1])
    heads = torch.repeat_interleave(torch.arange(emb.shape[0], device=emb.device), counts)
    upd = torch.zeros_like(emb64).index_add_(0, heads, rows_ref[:live])
    T_h = torch.zeros_like(emb64).index_add_(0, heads, T[:live])
    n_h = (counts.clamp(min=1) * n_terms_row).to(torch.float64)[:, None]
    nxt = torch.where((counts > 0)[:, None], emb64 + alpha * upd, emb64)
    tol = alpha * U32 * (TOL_TERMS_SGD * T_h + TOL_WALK * n_h.sqrt() * upd.abs()) \
        + 2 * U32 * (emb64.abs() + alpha * upd.abs())
    return nxt, upd, heads, tol


def check_sgd_epoch(torch, uk, shape, src, emb, row_heads, tails, p, perm, offs, u, a, b, reps, scale,
                    seed, parent_ms=None):
    """K10 at one shape, both epilogues, each against its plain version in
    f64 on the same inputs. ``emb`` (n_head, C) holds the heads' rows
    (``row_heads`` (R,) ascending; ``emb`` is ``src`` on the fit's self
    table), ``scale`` the attractive factor (2 on the self table, 1 in the
    transform's refine epochs). ROWS with the streamed ``u`` (its control:
    the repulsive term dropped on even rows) and with the kernel's draws of
    ``seed`` (their bits equal to the plain hash's bit for bit; control: the
    top bit of every slot's hash flipped); STEP with the kernel's draws
    (controls: every head's second row skipped, where heads have two), two
    launches equal bit for bit. With ``reps``: ms of both (STEP with its
    draws, ROWS with streamed u), their plain versions' ms, and bounds; and,
    given ``parent_ms``, both must beat the parent kernel's ms."""
    f64 = torch.float64
    R, K = tails.shape
    n_tab, C = src.shape
    neg = offs.shape[0]
    h = emb[row_heads.long()]
    rows = uk.head_rows(row_heads, p, emb.shape[0], C)
    live = int(rows.off[-1])
    res = {"shape": shape, "R": R, "K": K, "C": C, "neg": neg, "n_tab": n_tab, "n_head": emb.shape[0],
           "rows_live": live, "attract_scale": scale, "active_slots_streamed": int((u < p).sum())}
    controls = []

    def held_or_fail(what, out, ref, tol):
        r = k10_ratio(torch, out, ref, tol)
        check(r <= 1.0, f"K10 {what} at the {shape} shape: |d|/tol {r:.3g} above 1")
        return float((out.to(f64) - ref).abs().max()), r

    def caught(what, bad, ref, tol):
        r = k10_ratio(torch, bad, ref, tol)
        check(r > 1.0, f"the K10 check at the {shape} shape does not catch: {what} (err/tol {r:.3g})")
        controls.append({"control": what, "max_abs_err": float((bad.to(f64) - ref).abs().max()),
                         "err_over_tol": r})

    # ROWS, streamed u
    out = uk.sgd_epoch_rows(src, h, tails, p, perm, offs, u, a, b, 1.0, scale)
    ref, _, tol = k10_rows_band(torch, uk, src, h, tails, p, perm, offs, u, a, b, scale)
    res["rows_max_abs_err"], res["rows_err_over_tol"] = held_or_fail("ROWS (streamed u)", out, ref, tol)
    bad = out.clone()
    bad[::2] = uk.sgd_epoch_rows_plain(src, h, tails, p, perm, offs, u, a, b, 0.0, scale)[::2]
    caught("repulsive term dropped on even rows", bad, ref, tol)
    # ROWS with the kernel's draws: their bits, then the sums
    bits = torch.empty((R, K), dtype=torch.int32, device=src.device)
    out_d = uk.sgd_epoch_rows(src, h, tails, p, perm, offs, None, a, b, 1.0, scale, seed=seed, bits_out=bits)
    plain_bits = uk.slot_bits_plain(seed, R, K, src.device)
    n_diff = int(((bits.to(torch.int64) & 0xFFFFFFFF) != plain_bits).sum())
    check(n_diff == 0, f"K10's draws differ from the plain hash in {n_diff} slots at the {shape} shape")
    u_d = (plain_bits >> 8).to(f64) * 2.0 ** -24
    res["active_slots"] = int((u_d < p).sum())
    ref_d, T_d, tol_d = k10_rows_band(torch, uk, src, h, tails, p, perm, offs, u_d, a, b, scale)
    res["drawn_rows_max_abs_err"], res["drawn_rows_err_over_tol"] = held_or_fail("ROWS (its draws)", out_d, ref_d,
                                                                                 tol_d)
    u_flip = ((plain_bits ^ (1 << 31)) >> 8).to(f64) * 2.0 ** -24
    caught("top bit of the slot hash flipped", uk.sgd_epoch_rows_plain(
        src.to(f64), h.to(f64), tails, p.to(f64), perm, offs, u_flip, a, b, 1.0, scale), ref_d, tol_d)
    # STEP with the kernel's draws
    nxt_buf = torch.empty_like(emb)
    nxt = uk.sgd_epoch_step(emb, src, rows, tails, p, perm, offs, a, b, 1.0, scale, K10_ALPHA, seed=seed,
                            out=nxt_buf).clone()
    again = uk.sgd_epoch_step(emb, src, rows, tails, p, perm, offs, a, b, 1.0, scale, K10_ALPHA, seed=seed,
                              out=nxt_buf)
    check(torch.equal(nxt, again), f"two K10 STEP launches differ at the {shape} shape")
    ref_s, upd_ref, heads, tol_s = k10_step_band(torch, emb, rows.off, ref_d, T_d, K * (1 + neg), K10_ALPHA)
    res["max_abs_err"], res["err_over_tol"] = held_or_fail("STEP (its draws)", nxt, ref_s, tol_s)
    counts = rows.off.diff()
    second = rows.off[:-1][counts >= 2] + 1
    res["heads_with_two_rows"] = int(second.numel())
    if second.numel():
        skip = torch.zeros_like(upd_ref).index_add_(0, heads[second], ref_d[second])
        caught("every head's second row skipped in STEP", emb.to(f64) + K10_ALPHA * (upd_ref - skip), ref_s, tol_s)
    res["controls"] = controls
    if reps:
        # the kernels' device time (their wrappers' host time apart: it can
        # exceed the device's), the plain versions' by CUDA events
        reps = max(20, reps)
        res["rows_ms"], res["rows_host_us"] = device_host(torch, lambda: uk.sgd_epoch_rows(
            src, h, tails, p, perm, offs, u, a, b, 1.0, scale), reps)
        res["rows_plain_ms"] = cuda_ms(torch, lambda: uk.sgd_epoch_rows_plain(src, h, tails, p, perm, offs, u, a,
                                                                              b, 1.0, scale), reps)
        res["ms"], res["host_us"] = device_host(torch, lambda: uk.sgd_epoch_step(
            emb, src, rows, tails, p, perm, offs, a, b, 1.0, scale, K10_ALPHA, seed=seed, out=nxt_buf), reps)
        res["plain_ms"] = cuda_ms(torch, lambda: uk.sgd_epoch_step_plain(
            emb, src, rows, tails, p, perm, offs, a, b, 1.0, scale, K10_ALPHA, seed=seed), reps)
        res["library_ms"] = res["rows_library_ms"] = None  # no single PyTorch call computes an epoch
        # per evaluated term (active slot x (1 + neg)): 3C for diff and d2,
        # ~10 for the coefficient, 3C to clip and add
        per_term = (1.0 + neg) * (6.0 * C + 10.0)
        # ROWS: tails, p, u streamed once; table, heads, perm, offs read once; sums written
        res["rows_bound_ms"], res["rows_bound_by"] = bound_ms(
            4.0 * (3 * R * K + n_tab * C + R * C + n_tab + neg + R * C), res["active_slots_streamed"] * per_term)
        # STEP: the live rows' tails, p and heads, perm, offs, the row
        # offsets, the embedding in and out, and (transform) the frozen
        # table; no u
        table_bytes = 0 if src.data_ptr() == emb.data_ptr() else n_tab * C
        res["bound_ms"], res["bound_by"] = bound_ms(
            4.0 * (2 * live * K + live + n_tab + neg + 2 * (emb.shape[0] + 1) + 2 * emb.shape[0] * C + table_bytes),
            res["active_slots"] * per_term + 2.0 * emb.shape[0] * C)
        if parent_ms is not None:
            # a constant from step 0 (run A), not this run's: the gate's
            res["parent_ms_step0_run_A"] = parent_ms
            check(res["ms"] < parent_ms and res["rows_ms"] < parent_ms,
                  f"K10 at the {shape} shape is not faster than the parent kernel's {parent_ms:.4f} ms: STEP "
                  f"{res['ms']:.4f}, ROWS {res['rows_ms']:.4f}")
    return res


def phase_kernels(torch, X_pca, n_rows, reps, seed):
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    dev = X_pca.device
    m_pca = torch.zeros(X_pca.shape[0], device=dev)
    m_pca[:n_rows] = 1.0
    X = X_pca[:n_rows]
    m = torch.ones(n_rows, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    res = {}

    res["shifted_gram"] = k1 = check_shifted_gram(torch, lin, X_pca, m_pca, reps, control=True)
    emit({"phase": "kernels", "kernel": "shifted_gram", **k1})
    if reps:  # the redesigned kernel must beat the plain version it replaces
        check(k1["ms"] < k1["plain_ms"],
              f"shifted_gram {k1['ms']:.3f} ms not below its plain version's {k1['plain_ms']:.3f} ms")
    res.update(phase_gram_shapes(torch, lin, X_pca, n_rows, reps, g))

    y = (X[:, 0] > X[:, 0].median()).float()
    res["logreg_loss_grad"] = check_logreg(torch, lk, X, y, m, 1, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **res["logreg_loss_grad"]})
    res["logreg_loss_grad_10"] = k10 = check_logreg(torch, lk, X, y, m, 10, reps, seed, control=True)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", **k10})
    if reps:  # the multinomial kernel must beat the plain version it replaces
        check(k10["ms"] < k10["plain_ms"],
              f"logreg_loss_grad K=10 {k10['ms']:.3f} ms not below its plain version's {k10['plain_ms']:.3f} ms")

    # ragged shapes: n, d, k and K off every tile size
    for n_r, d_r in ((100_003, 300), (50_001, 124), (1_037, 3000)):
        Xr = torch.randn(n_r, d_r, generator=g, device=dev) + 3.0
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        yr = (torch.rand(n_r, generator=g, device=dev) > 0.5).float()
        emit({"phase": "kernels", "kernel": "shifted_gram", "ragged": True,
              **check_shifted_gram(torch, lin, Xr, mr, 0)})
        for K_r in (1, 5, 130):
            emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True,
                  **check_logreg(torch, lk, Xr, yr, mr, K_r, 0, seed)})
        del Xr
    # K1 off its float4 path: d % 4 != 0 (one column past a tile, and
    # narrower than half a tile), and a base 4 bytes off 16-byte alignment
    for n_r, d_r, offset in ((100_003, 257, 0), (50_001, 61, 0), (100_003, 256, 1)):
        buf = torch.randn(n_r * d_r + offset, generator=g, device=dev) + 3.0
        Xr = buf[offset:].view(n_r, d_r)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        emit({"phase": "kernels", "kernel": "shifted_gram", "ragged": True, "misaligned": bool(offset),
              **check_shifted_gram(torch, lin, Xr, mr, 0)})
        del buf, Xr
    # the multinomial register-row kernel off its tiles (d = 124, K = 5
    # above lands there too)
    Xr = torch.randn(100_003, 252, generator=g, device=dev) + 3.0
    mr = (torch.rand(100_003, generator=g, device=dev) > 0.1).float()
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True,
          **check_logreg(torch, lk, Xr, mr, mr, 13, 0, seed)})
    del Xr
    ragged_logreg_checks(torch, lk, g, seed)
    # K3's tile kernel at the general route's three timed shapes (the
    # reference's CI width, and multinomial fits past the register-row
    # kernel's d <= 256 and K <= 16), at the wide fit's 1,024,000 x 3,000
    # (a zero-copy view of the 12M x 256 rows, with the controls); the
    # route past the tile kernel's cap at its five timed shapes (the
    # logreg_many fit's 1,024,000 x 1,024 a view of the same rows), with
    # the controls (one-pass TF32 products among them); its class-tiled
    # instance at its four (the logreg_1k fit's 1,281,167 x 2,048 a view of
    # the same rows), likewise; the cluster kernel at its four (all but
    # 20,000 x 20,000 views of the same rows), with the controls and the
    # general kernel timed beside it; and the general kernel at the shape
    # it keeps (a view)
    routed = K3_ROUTE_SHAPES + K3_TILED_SHAPES
    for n_r, d_r, K_r, ctl in ([(K3_GENERAL_ROWS, d, K, False) for d, K in K3_GENERAL_SHAPES]
                               + [(n, d, K, True) for n, d, K in routed + K3_CLUSTER_SHAPES + K3_GENERAL_KEPT]):
        if n_r * d_r <= X.numel() and (n_r > K3_GENERAL_ROWS or n_r * d_r > 10 ** 9):
            Xr = X.reshape(-1)[:n_r * d_r].view(n_r, d_r)
        else:
            Xr = torch.randn(n_r, d_r, generator=g, device=dev)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        yr = (torch.rand(n_r, generator=g, device=dev) > 0.5).float()
        key = k3_key(n_r, d_r, K_r)
        res[key] = check_logreg(torch, lk, Xr, yr, mr, K_r, reps, seed, control=ctl, strict=ctl)
        emit({"phase": "kernels", "kernel": "logreg_loss_grad", "shape": key, **res[key]})
        del Xr, mr, yr
        torch.cuda.empty_cache()
    n_w = n_rows * E2E_D // LOGREG_WIDE_D
    if n_w:
        Xw = X.reshape(-1)[:n_w * LOGREG_WIDE_D].view(n_w, LOGREG_WIDE_D)
        yw = (Xw[:, 0] > Xw[:, 0].median()).float()
        res["logreg_loss_grad_tile_wide"] = r = check_logreg(
            torch, lk, Xw, yw, torch.ones(n_w, device=dev), 1, reps, seed, control=True)
        emit({"phase": "kernels", "kernel": "logreg_loss_grad", "shape": "logreg_loss_grad_tile_wide", **r})
        del Xw, yw
    torch.cuda.synchronize()
    return res


def k3_key(n, d, K) -> str:
    """The measurement key of K3 at a timed shape: the tile kernel's of
    K3_GENERAL_SHAPES, the route's of K3_ROUTE_SHAPES, its class-tiled
    instance's of K3_TILED_SHAPES, the cluster kernel's of
    K3_CLUSTER_SHAPES, the general kernel's of K3_GENERAL_KEPT."""
    if (n, d, K) in K3_CLUSTER_SHAPES:
        return f"logreg_loss_grad_cluster_n{n}_d{d}"
    if (n, d, K) in K3_ROUTE_SHAPES:
        return f"logreg_loss_grad_route_n{n}_d{d}_K{K}"
    if (n, d, K) in K3_TILED_SHAPES:
        return f"logreg_loss_grad_tiled_n{n}_d{d}_K{K}"
    if (n, d, K) in K3_GENERAL_KEPT:
        return f"logreg_loss_grad_general_n{n}_d{d}_K{K}"
    return f"logreg_loss_grad_tile_d{d}_K{K}"


def k3_gates(res) -> dict:
    """K3's gates: the tile kernel ran each timed shape of
    K3_GENERAL_SHAPES and the wide fit's, the route each of
    K3_ROUTE_SHAPES (past the tile kernel's cap), each below its plain
    version, its class-tiled instance each of K3_TILED_SHAPES, below its
    plain version and below one autograd call of it, the cluster kernel
    each of K3_CLUSTER_SHAPES, below its plain version, one autograd call
    and the general kernel it replaced there, and the general kernel each
    shape it keeps (K3_GENERAL_KEPT). Returns each gate's verdict; the
    caller fails the run on any False."""
    out = {}
    keys = [k3_key(K3_GENERAL_ROWS, d, K) for d, K in K3_GENERAL_SHAPES] + (
        ["logreg_loss_grad_tile_wide"] if "logreg_loss_grad_tile_wide" in res else [])
    for key in keys:
        r = res[key]
        out[f"{key}_ran_tile"] = r["variant"].startswith("tile")
        if "ms" in r:
            out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
    for key in (k3_key(n, d, K) for n, d, K in K3_ROUTE_SHAPES):
        r = res[key]
        out[f"{key}_ran_route"] = r["variant"].startswith("route")
        if "ms" in r:
            out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
    for key in (k3_key(n, d, K) for n, d, K in K3_TILED_SHAPES):
        r = res[key]
        out[f"{key}_ran_tiled"] = r["variant"].startswith("route(tiled")
        if "ms" in r:
            out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
            out[f"{key}_below_autograd"] = r["ms"] < r["library_ms"]
    for key in (k3_key(n, d, K) for n, d, K in K3_CLUSTER_SHAPES):
        r = res[key]
        out[f"{key}_ran_cluster"] = r["variant"].startswith("cluster")
        if "ms" in r:
            out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
            out[f"{key}_below_autograd"] = r["ms"] < r["library_ms"]
            out[f"{key}_below_general"] = r["ms"] < r["general_ms"]
    for key in (k3_key(n, d, K) for n, d, K in K3_GENERAL_KEPT):
        out[f"{key}_ran_general"] = res[key]["variant"] == "general"
    return out


# K3's tile kernel off its 16-byte copies and tiles, and at every instance
# (gradient items a thread) the router can pick: (rows, d, K, offset of
# the base in floats)
K3_RAGGED_TILE = ((100_003, 3001, 1, 0), (100_003, 3000, 1, 1), (50_001, 124, 1, 1), (50_001, 512, 10, 1),
                  (100_003, 257, 20, 0), (1_037, 130, 3, 0), (5, 3000, 1, 0), (7, 300, 5, 0),
                  (20_011, 4, 300, 0), (20_011, 1152, 1, 0), (20_011, 6000, 1, 0), (4_099, 16_380, 1, 0),
                  (20_011, 255, 32, 1))
# the route past the tile kernel's cap at every instance (wgmma N 16, 32,
# 64, 128 and 2 x 128) off its tiles: d % 4 != 0 and a base 4 bytes off
# 16-byte alignment (4-byte cp.async copies in place of TMA), fewer rows
# than a row tile, K not a multiple of 8 (padded classes live), K = 2 at
# d = 5,000, K = 256, K = 120 at d = 2,048, 130 classes (the second
# warpgroup's 126 padded), and rows past one launch pair's R^T scratch
# (two chunks at 256 classes); the class-tiled instance (K > 256) with
# d % 4 != 0, a misaligned base, K = 257 (a last class tile of one
# class), K = 1,000 and 4,097, each over two launch pairs
K3_RAGGED_ROUTE = ((20_011, 1023, 64, 0), (20_011, 1024, 24, 1), (100, 2000, 10, 0), (20_011, 512, 37, 0),
                   (20_011, 5000, 2, 0), (20_011, 300, 256, 0), (20_011, 2048, 120, 0), (20_011, 130, 130, 1),
                   (300_000, 260, 256, 0), (70_001, 1023, 1000, 0), (200_003, 130, 257, 0),
                   (20_011, 1024, 257, 1), (20_011, 261, 4097, 1))
# the cluster kernel (binomial 16,380 < d <= 262,144) at every cluster
# size and instance the geometry picks: just past the tile kernel's cap
# (d % 4 != 0: rows off 16-byte alignment, C = 2), C = 2's widest slice
# on a base 4 bytes off alignment, a last rank whose slice ends inside a
# chunk (d = 30,001), fewer rows than the clusters the card holds (C =
# 4), 5 rows (C = 8) and C = 8 off alignment, C = 16 aligned and off
# alignment; and one shape past its widest d, which the general kernel
# takes. Their rows are drawn so that the logits are O(1) (a saturated
# logit hides a wrong partial from the band), and each is held with every
# control, the dropped rank among them.
K3_RAGGED_CLUSTER = ((4_099, 16_381, 1, 0), (3_001, 32_768, 1, 1), (1_037, 30_001, 1, 0),
                     (20, 65_536, 1, 0), (5, 100_000, 1, 0), (1_031, 120_001, 1, 1), (1_003, 262_144, 1, 0),
                     (777, 200_003, 1, 1), (1_003, 262_147, 1, 0))


def ragged_logreg_checks(torch, lk, g, seed):
    """K3 at K3_RAGGED_TILE and K3_RAGGED_ROUTE, each held against its f64
    plain version and naming the kernel that ran it (its launcher code, as
    counted by the wrapper): d % 4 != 0, a base 4 bytes off 16-byte
    alignment (4-byte copies), fewer rows than a tile or than the grid,
    more classes than a block has threads, padded classes; and at
    K3_RAGGED_CLUSTER, with every control, on rows and an A that keep the
    logits O(1). Fails unless every instance of
    the tile kernel, of the route and of the cluster kernel, and every
    cluster size the cluster kernel's geometry picks, launched, and the
    general kernel past the cluster kernel's widest d."""
    dev = g.device
    launched, sizes, misaligned = set(), set(), False
    for n_r, d_r, K_r, offset in K3_RAGGED_TILE + K3_RAGGED_ROUTE + K3_RAGGED_CLUSTER:
        cl = (n_r, d_r, K_r, offset) in K3_RAGGED_CLUSTER
        buf = torch.randn(n_r * d_r + offset, generator=g, device=dev) + (0.0 if cl else 3.0)
        Xr = buf[offset:].view(n_r, d_r)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        yr = (torch.rand(n_r, generator=g, device=dev) > 0.5).float()
        before = dict(lk.logreg_loss_grad.variants)
        # the route's and the cluster kernel's every instance with the
        # controls too (most run only here); the cluster kernel's with A
        # scaled by 1/sqrt(d), so its logits x.a are O(1) and a dropped
        # rank moves the residuals
        r = check_logreg(torch, lk, Xr, yr, mr, K_r, 0, seed, control=cl or (n_r, d_r, K_r, offset) in K3_RAGGED_ROUTE,
                         strict=cl, a_std=d_r ** -0.5 if cl else 0.05)
        codes = [c for c, v in lk.logreg_loss_grad.variants.items() if v != before.get(c, 0)]
        check(len(codes) == 1, f"logreg_loss_grad {n_r}x{d_r} K={K_r}: launched codes {codes}, not one")
        launched.update(codes)
        if codes[0] >= lk._CLUSTER:
            r["geometry"] = lk._cluster_geometry(n_r, d_r)._asdict()
            sizes.add(r["geometry"]["C"])
            misaligned |= offset != 0 or d_r % 4 != 0
        emit({"phase": "kernels", "kernel": "logreg_loss_grad", "ragged": True, "misaligned": bool(offset),
              "code": codes[0], **{k: v for k, v in r.items() if k != "controls"},
              **({"controls": [(c["control"], c["err_over_tol"]) for c in r["controls"]]} if "controls" in r else {})})
        del buf, Xr
    tile = {1000 + i for i in lk._TILE_IPT[False]} | {2000 + i for i in lk._TILE_IPT[True]}
    check(tile <= launched, f"logreg_loss_grad: tile instances {sorted(tile - launched)} never launched")
    route = {3000 + bn for bn in lk._ROUTE_BN} | {3256, lk._ROUTE_TILED}
    check(route <= launched, f"logreg_loss_grad: route instances {sorted(route - launched)} never launched")
    # the cluster kernel, on both its instances (aligned and not), and
    # every cluster size its geometry picks over its whole range of d
    check(lk._CLUSTER + lk._CLUSTER_IPT in launched and misaligned,
          "logreg_loss_grad: the cluster kernel never launched on both its instances")
    picked = {lk._cluster_geometry(1, d).C for d in range(16_381, lk._CLUSTER_D_MAX + 1, 97)}
    check(picked <= sizes, f"logreg_loss_grad: cluster sizes {sorted(picked - sizes)} never launched")
    check(0 in launched, "logreg_loss_grad: the general kernel never launched past the cluster kernel's widest d")


# K3's tile kernel, timed (rows, then (d, K)): the reference's CI smoke
# width (BASELINE.md, binomial), and 10 and 32 classes past the
# multinomial register-row kernel's d <= 256, K <= 16
K3_GENERAL_ROWS = 200_000
K3_GENERAL_SHAPES = ((3000, 1), (512, 10), (256, 32))
# the reference's LogisticRegression benchmark (BASELINE.md: 1M x 3,000
# f32, binomial, maxIter 200): 1,024,000 x 3,000 is the 12M x 256 buffer
LOGREG_WIDE_ROWS = 1_024_000
LOGREG_WIDE_D = 3000
# the wide fit's rows fitted on the card and on the CPU (maxIter 20)
LOGREG_WIDE_SUBSET = 50_000
# logreg_many: a 64-class LogisticRegression over 1,024-wide rows (inside
# the JAX package's Pallas gate: d % 128 == 0, K <= 120), 1,024,000 x
# 1,024 as a view of the 12M x 256 rows: K3's route past the tile
# kernel's cap; its first 20,000 rows fitted on the card and on the CPU
LOGREG_MANY_ROWS = 1_024_000
LOGREG_MANY_D = 1024
LOGREG_MANY_CLASSES = 64
LOGREG_MANY_SUBSET = 20_000
# the label map's weights: W ~ N(0, LOGREG_MANY_W^2)
LOGREG_MANY_W = 0.2
# card vs CPU on the subset: 20 L-BFGS steps in f32 on each side, the
# card's products in 3xTF32 (f32 rounding, other sums): the 12M path's
# coefficient tolerance and the 10-class path's agreement; a disagreement
# whose top two logits (CPU model) lie within MANY_NEAR_TIE is a near tie
MANY_COEF_TOL = 0.05
MANY_AGREE_MIN = 0.995
MANY_NEAR_TIE = 1e-3
# logreg_1k: the linear-evaluation protocol on frozen ResNet-50 features
# (He et al. 2016: 2,048-wide pooled features; ILSVRC-2012's training set:
# 1,281,167 images, 1,000 classes), LogisticRegression(maxIter=20,
# regParam=1e-5) on 1,281,167 x 2,048 f32, a zero-copy view of the 12M x
# 256 host rows (2.62e9 of their 3.07e9 floats; nothing cut): K3's
# class-tiled instance. Its first 50,000 rows (50 a class) fitted on the
# card and on the CPU, held to MANY_AGREE_MIN (and to MANY_COEF_TOL at
# LOGREG_1K_SUBSET_REG); the transform on its first 131,072 rows only (the whole output's
# probability and raw-prediction columns would be 2 x 5.1 GB on the host)
LOGREG_1K_ROWS = 1_281_167
LOGREG_1K_D = 2048
LOGREG_1K_CLASSES = 1000
LOGREG_1K_SUBSET = 50_000
LOGREG_1K_TRANSFORM = 131_072
# the card-vs-CPU fit's coefficients are held at this regParam, where
# the optimum is well conditioned and 20 iterations reach it; at the
# path's 1e-5 the 50,000 rows (2.05M coefficients) are separable, so two
# f32 fits part along the L-BFGS path by far more than MANY_COEF_TOL
# whatever computes the gradient (the CPU fit moves as far from itself
# when only its gradient's rounding changes): there the run holds the
# predictions' agreement and reports the coefficients' distance
LOGREG_1K_SUBSET_REG = 1e-2
# the label map's weights: W ~ N(0, LOGREG_1K_W^2), picked once so that
# the label map's own accuracy on these rows lands near the other paths'
# 0.77-0.79 (0.787 on 6,000 rows drawn like them on the CPU)
LOGREG_1K_W = 0.2
# logreg_realsim: binomial LogisticRegression at the shape of LIBSVM's
# real-sim (72,309 x 20,958; the data table of Fan et al., JMLR 2008,
# LIBLINEAR), with the reference benchmark's parameters (BASELINE.md:
# maxIter 200, tol 1e-30, regParam 1e-5), on a zero-copy view of the 12M x
# 256 host rows (1.515e9 of their 3.072e9 floats, Gaussian; no data
# downloaded), labels from a seeded hyperplane plus logistic noise (as
# logreg_wide's): K3's cluster kernel. Its first 20,000 rows fitted on the
# card and on the CPU with maxIter 20: fewer rows than features, so at
# regParam 1e-5 they are separable and two f32 fits part by any rounding
# (the predictions held to MANY_AGREE_MIN, the coefficients' distance
# reported), at LOGREG_1K_SUBSET_REG the coefficients held to MANY_COEF_TOL
LOGREG_REALSIM_ROWS = 72_309
LOGREG_REALSIM_D = 20_958
LOGREG_REALSIM_SUBSET = 20_000
# K3's route past the tile kernel's cap (two 3xTF32 products), timed
# (rows, d, K): 64 classes at d = 256 and 1,024, the corner of the JAX
# package's Pallas gate (d = 2,048, K = 120), 200 classes (the split
# instance, where the class-tiled one also runs but slower), and the
# logreg_many fit's 1,024,000 x 1,024 (last)
K3_ROUTE_SHAPES = ((200_000, 256, 64), (200_000, 1024, 64), (200_000, 2048, 120), (200_000, 1024, 200),
                   (1_024_000, 1024, 64))
# the route's class-tiled instance (K > 256), timed (rows, d, K): just
# past 256 classes (two full class tiles and a ragged third), the general
# kernel's old 1,000-class shape, the logreg_1k fit's 1,281,167 x 2,048
# (a view of the 12M x 256 rows), and 4,096 classes at a narrow width
K3_TILED_SHAPES = ((200_000, 512, 300), (100_000, 2048, 1000), (1_281_167, 2048, 1000), (100_000, 256, 4096))
# the cluster kernel (binomial 16,380 < d <= 262,144), timed beside its
# autograd call and the general kernel it replaced there: the general
# kernel's old shape, the logreg_realsim fit's (LIBSVM's real-sim), the
# whole 12M x 256 buffer at 65,536 columns, and Spark's HashingTF default
# width (2^18 features), the last three views of the 12M x 256 rows
K3_CLUSTER_SHAPES = ((20_000, 20_000, 1), (72_309, 20_958, 1), (46_875, 65_536, 1), (11_718, 262_144, 1))
# the shape the general kernel keeps (binomial d > 262,144), timed beside
# its autograd call: HashingTF's 2^20 features over the whole buffer
K3_GENERAL_KEPT = ((2_929, 1 << 20, 1),)
# the tile kernel's <1, 8> (binomial 4,092 < d <= 8,188) and <1, 16>
# (8,188 < d <= 16,380) instances, timed
K3_TILE_WIDE = ((200_000, 8000, 1), (100_000, 16_380, 1))
# --logreg-only: (rows, d, K)
K3_PROBE_SHAPES = K3_TILED_SHAPES + K3_ROUTE_SHAPES + K3_CLUSTER_SHAPES + K3_GENERAL_KEPT + K3_TILE_WIDE
# --logreg-only forces the general kernel beside the routed one where it
# launches (not at 4,096 classes: its 48 KB logit tile with its static
# shared memory is refused) and takes at most ~5 s a call (not at
# 1,281,167 x 2,048, K = 1,000: ~52 s)
K3_PROBE_GENERAL_SKIP = ((1_281_167, 2048, 1000), (100_000, 256, 4096))


# K2 at k = 1024 must take at most three quarters of the 194.61 ms of the
# kernel it replaced (H100 80GB HBM3 at 700 W)
LLOYD_MS_MAX = 146.0


def phase_lloyd_kernels(torch, X, reps, seed):
    """K2 at the two shapes the main path gives it, each timed with its
    controls: k = 1024 (the Lloyd iterations) and k = 4,097
    (count_closest over the k-means|| candidates: 1 + 2 steps x 2k draws at
    oversampling 2); and at ragged shapes, n, d and k off every tile, d %
    4 != 0 and a base 4 bytes off 16-byte alignment, at k in {1, 37, 130}."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk

    n, dev = X.shape[0], X.device
    m = torch.ones(n, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    res = {}
    idx = torch.randint(0, n, (4097,), generator=g, device=dev)
    C1024 = X[idx[:1024]] + 0.1 * torch.randn(1024, E2E_D, generator=g, device=dev)
    res["lloyd_step"] = check_lloyd_step(torch, kk, X, m, C1024.contiguous(), reps, control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step"]})
    res["lloyd_step_4097"] = check_lloyd_step(torch, kk, X, m, X[idx].contiguous(), max(1, reps // 2),
                                              control=True)
    emit({"phase": "kernels", "kernel": "lloyd_step", **res["lloyd_step_4097"]})
    del m
    for n_r, d_r, offset in ((100_003, 300, 0), (50_001, 124, 0), (1_037, 3000, 0), (100_003, 257, 0),
                             (50_001, 61, 0), (100_003, 256, 1)):
        buf = torch.randn(n_r * d_r + offset, generator=g, device=dev) + 3.0
        Xr = buf[offset:].view(n_r, d_r)
        mr = (torch.rand(n_r, generator=g, device=dev) > 0.1).float()
        for k_r in (1, 37, 130):
            Cr = Xr[torch.randint(0, n_r, (k_r,), generator=g, device=dev)].contiguous()
            emit({"phase": "kernels", "kernel": "lloyd_step", "ragged": True, "misaligned": bool(offset),
                  **check_lloyd_step(torch, kk, Xr, mr, Cr, 0)})
        del buf, Xr
    torch.cuda.synchronize()
    return res


def lloyd_gates(res) -> dict:
    """K2's gates: below its plain version and its library call at k =
    1024 and k = 4,097, and at most LLOYD_MS_MAX at k = 1024. Returns each
    gate's verdict; the caller fails the run on any False."""
    out = {}
    for key in ("lloyd_step", "lloyd_step_4097"):
        r = res[key]
        out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
        out[f"{key}_below_library"] = r["ms"] < r["library_ms"]
    out["lloyd_step_at_most_ms_max"] = res["lloyd_step"]["ms"] <= LLOYD_MS_MAX
    return out


def make_umap_data(n: int, seed: int) -> np.ndarray:
    """(n, 256) f32 host rows: 32 Gaussian blobs (centre scale 4, unit
    noise), the recipe of ``bench.py``'s UMAP entry (its seed 3 at
    ``--seed 0``)."""
    rng = np.random.default_rng(seed + 3)
    centers = rng.normal(size=(32, E2E_D)).astype(np.float32) * 4.0
    lab = rng.integers(0, 32, size=n)
    return (centers[lab] + rng.normal(size=(n, E2E_D))).astype(np.float32)


def make_cluster_data(torch, seed: int, dev) -> np.ndarray:
    """(70,000, 784) f32 host rows made on ``dev`` from ``seed``: 10
    Gaussian blobs (centre scale 4, unit noise), MNIST's shape."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 70)
    centres = torch.randn((CLUSTER_BLOBS, CLUSTER_D), generator=g, device=dev) * 4.0
    lab = torch.randint(0, CLUSTER_BLOBS, (CLUSTER_ROWS,), generator=g, device=dev)
    return (centres[lab] + torch.randn((CLUSTER_ROWS, CLUSTER_D), generator=g, device=dev)).cpu().numpy()


def query_sample(torch, nq, dev, rows=4096):
    """``rows`` query rows: the first query tile (the negative control
    shifts its ids), then rows spread over the rest."""
    step = max(1, (nq - 128) // (rows - 128))
    return torch.cat([torch.arange(min(128, nq), device=dev),
                      torch.arange(128, nq, step, device=dev)[:rows - 128]])


KNN_JOIN_QUERIES = 4096  # exactNearestNeighborsJoin's queries in the kNN path
# K4 at the kNN shape must take at most half of the 2,142.10 ms of the
# kernel it replaced (H100 80GB HBM3 at 700 W)
KNN_MS_MAX = 1071.0


def phase_knn_kernels(torch, X_items, X_umap, reps, seed):
    """K4 at the four shapes the main path gives it, each timed: kNN
    (131,072 queries x 1M items, k = 16, with its negative controls), the
    join (4,096 queries x 1M), the UMAP graph (65,536 rows against
    themselves, k = 16) and the UMAP transform (k = 15); and in full at
    ragged shapes."""
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    dev = X_items.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    res = {}
    nq, ni = min(KNN_QUERIES, X_items.shape[0]), X_items.shape[0]
    ones = torch.ones(ni, device=dev)
    res["knn_topk"] = check_knn_topk(torch, kn, X_items[:nq], X_items, ones, KNN_K,
                                     sample=query_sample(torch, nq, dev), reps=max(1, reps // 3), control=True)
    emit({"phase": "kernels", "kernel": "knn_topk", **res["knn_topk"]})
    nj = min(KNN_JOIN_QUERIES, ni)
    res["knn_topk_join"] = check_knn_topk(torch, kn, X_items[:nj], X_items, ones, KNN_K,
                                          sample=query_sample(torch, nj, dev, rows=1024), reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "join_shape": True, **res["knn_topk_join"]})
    del ones
    # ragged shapes: nq, ni off the tiles, a masked item block, d in {3,
    # 124, 300}, k in {1, 16, 100, 128} (128: the 64-row blocks), and one
    # fold in two passes
    for d_r in (3, 124, 300):
        Xq = torch.randn(1037, d_r, generator=g, device=dev) + 3.0
        Xi = torch.randn(70_001, d_r, generator=g, device=dev) + 3.0
        mask = torch.ones(70_001, device=dev)
        mask[5000:7000] = 0.0
        for k_r in (1, 16, 100, 128):
            emit({"phase": "kernels", "kernel": "knn_topk", "ragged": True,
                  **check_knn_topk(torch, kn, Xq, Xi, mask, k_r,
                                   split=30_011 if (d_r, k_r) == (124, 16) else None)})
    # the UMAP shapes: the graph (65,536 rows against themselves, k = 16)
    # and the transform of the same rows (k = 15)
    Xd = torch.from_numpy(X_umap).to(dev)
    n = Xd.shape[0]
    ones, sample = torch.ones(n, device=dev), query_sample(torch, n, dev)
    res["knn_topk_umap_graph"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS + 1, sample=sample,
                                                reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_graph_shape": True, **res["knn_topk_umap_graph"]})
    res["knn_topk_umap_transform"] = check_knn_topk(torch, kn, Xd, Xd, ones, UMAP_NEIGHBORS, sample=sample,
                                                    reps=max(1, reps))
    emit({"phase": "kernels", "kernel": "knn_topk", "umap_transform_shape": True,
          **res["knn_topk_umap_transform"]})
    torch.cuda.synchronize()
    return res


def knn_gates(res) -> dict:
    """K4's gates: below its plain version at all four shapes, below one
    chunked addmm + topk at the kNN and UMAP-graph shapes, and at most
    KNN_MS_MAX at the kNN shape. Returns each gate's verdict; the caller
    fails the run on any False."""
    out = {}
    for key in ("knn_topk", "knn_topk_join", "knn_topk_umap_graph", "knn_topk_umap_transform"):
        r = res[key]
        out[f"{key}_below_plain"] = r["ms"] < r["plain_ms"]
        if key in ("knn_topk", "knn_topk_umap_graph"):
            out[f"{key}_below_library"] = r["ms"] < r["library_ms"]
    out["knn_topk_at_most_ms_max"] = res["knn_topk"]["ms"] <= KNN_MS_MAX
    return out


def umap_rows(torch, uk, Xd, k: int, K: int = 24):
    """The UMAP fit's kNN graph of the rows ``Xd`` (k neighbours, self
    excluded, on their device), its fuzzy set and its CSR rows of K slots:
    ``(idx, row_heads, tails_pad, p_pad)``."""
    from spark_rapids_ml_tpu_torch.models.umap import drop_self_column, knn_brute

    dists, idx = drop_self_column(*knn_brute(Xd, Xd, k=k + 1), k=k)
    heads, tails, weights = uk.fuzzy_simplicial_set(idx.cpu().numpy(), dists, 1.0, 1.0, device=Xd.device)
    return (idx, *uk.build_row_adjacency(heads, tails, weights, Xd.shape[0], K=K))


def offset_view(torch, t):
    """A copy of ``t`` one row past the start of its buffer: off the 16
    bytes K10's vector loads assume when a row is 8 or 12 bytes."""
    buf = torch.empty((t.shape[0] + 1, *t.shape[1:]), dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def check_k10_offset_views(torch, uk, src, emb, tails, p, perm, offs, u, a, b, seed) -> bool:
    """K10's wrappers on a table and heads that both lie off 16 bytes (so
    that each wrapper copies both, and the two copies must not share
    memory) against the same calls on aligned tensors, bit for bit: ROWS
    with the streamed ``u`` and STEP with the kernel's draws, one row a
    head (``emb`` (R, C)), a frozen table ``src`` of the same shape."""
    src_v, emb_v = offset_view(torch, src), offset_view(torch, emb)
    check(src_v.data_ptr() % 16 != 0 and emb_v.data_ptr() % 16 != 0, "K10's offset views lie on 16 bytes")
    rows_ok = torch.equal(uk.sgd_epoch_rows(src_v, emb_v, tails, p, perm, offs, u, a, b, 1.0, 1.0),
                          uk.sgd_epoch_rows(src, emb, tails, p, perm, offs, u, a, b, 1.0, 1.0))
    rows = uk.head_rows(torch.arange(tails.shape[0], device=src.device), p, emb.shape[0], emb.shape[1])
    step_ok = torch.equal(
        uk.sgd_epoch_step(emb_v, src_v, rows, tails, p, perm, offs, a, b, 1.0, 1.0, K10_ALPHA, seed=seed),
        uk.sgd_epoch_step(emb, src, rows, tails, p, perm, offs, a, b, 1.0, 1.0, K10_ALPHA, seed=seed))
    check(rows_ok and step_ok, f"K10 on offset views differs from K10 on aligned tensors (ROWS equal: "
                               f"{rows_ok}, STEP equal: {step_ok})")
    return True


def phase_sgd_kernels(torch, X_umap, X_cluster, reps, seed, dev):
    """K10 (``check_sgd_epoch``) at the UMAP fit shape (the CSR rows of the
    65,536 x 256 graph, K = 24, C = 2, neg = 5), the transform shape (65,536
    rows, K = 15, neg = 5, frozen table; there also on offset views,
    ``check_k10_offset_views``), the umap_cluster shape (the CSR rows of
    the 70,000 x 784 graph of 30 neighbours, K = 24, C = 10: the generic
    instance) and that path's transform shape (70,000 rows, K = 30, a
    frozen 70,000 x 10 table), each on a random table, the first two of
    which must beat the parent kernel; then a ragged case (K = 40, neg =
    20, C = 3, a frozen table), held only."""
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    # K10 on the UMAP fit's own rows: its graph, a random table
    idx, row_heads, tails_pad, p_pad = umap_rows(torch, uk, torch.from_numpy(X_umap).to(dev), UMAP_NEIGHBORS)
    n = X_umap.shape[0]
    a, b = uk.find_ab_params(1.0, 0.1)
    src = torch.rand((n, 2), generator=g, device=dev) * 20.0 - 10.0
    tails_d, p_d = torch.from_numpy(tails_pad).to(dev), torch.from_numpy(p_pad).to(dev)
    R, K = tails_pad.shape
    u = torch.rand((R, K), generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev, dtype=torch.int32)
    offs = torch.randint(0, R, (5,), generator=g, device=dev, dtype=torch.int32)
    res = {"sgd_epoch": check_sgd_epoch(torch, uk, "fit", src, src, torch.from_numpy(row_heads).to(dev), tails_d,
                                        p_d, perm, offs, u, a, b, reps, 2.0, seed + 101, K10_PARENT_MS["fit"])}
    emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **res["sgd_epoch"]})
    # the transform's epoch: one row per query (R = 65,536), its K = 15
    # training neighbours into the frozen table, neg = 5 offsets in [0, R),
    # the attractive term once
    tails_tr = idx.contiguous()
    shp = tails_tr.shape
    offs_tr = torch.randint(0, shp[0], (5,), generator=g, device=dev, dtype=torch.int32)
    p_tr = torch.rand(shp, generator=g, device=dev)
    u_tr = torch.rand(shp, generator=g, device=dev)
    res["sgd_epoch_transform"] = check_sgd_epoch(
        torch, uk, "transform", src, src + 0.5, torch.arange(shp[0], device=dev), tails_tr, p_tr, perm, offs_tr,
        u_tr, a, b, reps, 1.0, seed + 102, K10_PARENT_MS["transform"])
    res["sgd_epoch_transform"]["offset_views_equal"] = check_k10_offset_views(
        torch, uk, src, src + 0.5, tails_tr, p_tr, perm, offs_tr, u_tr, a, b, seed + 102)
    emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **res["sgd_epoch_transform"]})
    # the umap_cluster fit's rows: 30 neighbours, K = 24, C = 10
    idx, row_heads, tails_pad, p_pad = umap_rows(torch, uk, torch.from_numpy(X_cluster).to(dev),
                                                 CLUSTER_NEIGHBORS)
    n = X_cluster.shape[0]
    a, b = uk.find_ab_params(1.0, CLUSTER_MIN_DIST)
    src = torch.rand((n, CLUSTER_COMPONENTS), generator=g, device=dev) * 20.0 - 10.0
    R, K = tails_pad.shape
    u = torch.rand((R, K), generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev, dtype=torch.int32)
    offs = torch.randint(0, R, (5,), generator=g, device=dev, dtype=torch.int32)
    res["sgd_epoch_cluster"] = check_sgd_epoch(
        torch, uk, "umap_cluster", src, src, torch.from_numpy(row_heads).to(dev), torch.from_numpy(tails_pad).to(dev),
        torch.from_numpy(p_pad).to(dev), perm, offs, u, a, b, reps, 2.0, seed + 103)
    emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **res["sgd_epoch_cluster"]})
    # the umap_cluster transform's epoch (the generic instance on a frozen
    # table): one row per query (R = 70,000), its K = 30 training
    # neighbours, neg = 5 offsets in [0, R), the attractive term once
    tails_tr = idx.contiguous()
    shp = tails_tr.shape
    offs_tr = torch.randint(0, shp[0], (5,), generator=g, device=dev, dtype=torch.int32)
    p_tr = torch.rand(shp, generator=g, device=dev)
    u_tr = torch.rand(shp, generator=g, device=dev)
    res["sgd_epoch_cluster_transform"] = check_sgd_epoch(
        torch, uk, "umap_cluster_transform", src, src + 0.5, torch.arange(shp[0], device=dev), tails_tr, p_tr, perm,
        offs_tr, u_tr, a, b, reps, 1.0, seed + 106)
    emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **res["sgd_epoch_cluster_transform"]})
    # ragged, held only: K = 40 slots (two chunks of a warp), 20 negatives
    # (past the staged ones), C = 3, a frozen table of another size
    rng = np.random.default_rng(seed + 104)
    n_head, n_tab = 3_001, 5_003
    deg = rng.integers(0, 120, size=n_head)
    heads = np.repeat(np.arange(n_head), deg)
    row_heads, tails_pad, p_pad = uk.build_row_adjacency(
        heads, rng.integers(0, n_tab, size=heads.size), rng.uniform(0.05, 1.0, size=heads.size).astype(np.float32),
        n_head, K=40, row_bucket=256)
    R = tails_pad.shape[0]
    table = torch.rand((n_tab, 3), generator=g, device=dev) * 20.0 - 10.0
    ragged = check_sgd_epoch(
        torch, uk, "ragged", table, torch.rand((n_head, 3), generator=g, device=dev) * 20.0 - 10.0,
        torch.from_numpy(row_heads).to(dev), torch.from_numpy(tails_pad).to(dev), torch.from_numpy(p_pad).to(dev),
        torch.randperm(n_tab, generator=g, device=dev, dtype=torch.int32),
        torch.randint(0, R, (20,), generator=g, device=dev, dtype=torch.int32), torch.rand((R, 40), generator=g,
                                                                                          device=dev), a, b, 0, 1.0,
        seed + 105)
    emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **ragged})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res


def phase_knn_umap_kernels(torch, X_items, X_umap, X_cluster, reps, seed):
    """K4 (``phase_knn_kernels``, gated) and K10 (``phase_sgd_kernels``)."""
    res = phase_knn_kernels(torch, X_items, X_umap, reps, seed)
    gates = knn_gates(res)
    emit({"phase": "kernels", "kernel": "knn_topk", "gates": gates, "ms_max": KNN_MS_MAX})
    for name, ok in gates.items():
        check(ok, f"K4 gate {name} failed: " + json.dumps(
            {k: {m: r[m] for m in ("ms", "plain_ms", "library_ms")} for k, r in res.items()}))
    res.update(phase_sgd_kernels(torch, X_umap, X_cluster, reps, seed, X_items.device))
    return res


def rf_level_inputs(torch, pt, bins, stats, level, T, k, n_features, g, sel=False, depth=RF_DEPTH,
                    bootstrap=True):
    """The inputs one compact level of the forest builder gives K5 (K6 with
    ``sel``) for T trees of ``depth`` levels, laid out by the builder's own
    glue (``compact_sizes``, ``_compact_layout``): each tree's rows
    (Poisson(1) bootstrap weights, or 1 without ``bootstrap``) spread over
    the level's 2^level nodes at random, each node's k features drawn at
    random, sentinel slots up to the next power of two. K5 reads the shared
    bins (k == n_features, no subset, as the GBT) or each tree's
    subset-gathered bins; K6 (``sel``) the shared full rows with the
    nodes' ids ``feats`` (T, n_nodes, k_pad) int32."""
    n, d_pad = bins.shape
    dev, S = bins.device, stats.shape[1]
    n_nodes, k_pad = 1 << level, pt.next_pow2(k)
    subset = k < n_features
    r_sub, n_pad, _ = pt.compact_sizes(n, level, depth, S, k_pad if subset else d_pad, RF_BINS)
    seg = torch.randint(0, n_nodes, (T, n), generator=g, device=dev)
    src2, pvalid, _, counts, pstart = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g) if bootstrap else torch.ones((T, n), device=dev)
    sw_rows = stats[None] * w[..., None]
    sw = sw_rows.gather(1, src2[..., None].expand(T, n_pad, S))
    sw = (sw * pvalid[..., None]).reshape(T * n_pad, S).contiguous()
    out = {"T": T, "level": level, "n": n, "n_pad": n_pad, "r_sub": r_sub, "S": S, "nb": RF_BINS,
           "k": k, "k_pad": k_pad, "sw": sw, "seg": seg, "sw_rows": sw_rows, "src2": src2, "counts": counts,
           "pstart": pstart, "n_nodes": n_nodes}
    if not subset:
        out["hist_src"] = bins
        return out
    feats = torch.rand((T, n_nodes, n_features), generator=g, device=dev).argsort(dim=2)[..., :k]
    feats = torch.cat([feats, torch.full((T, n_nodes, k_pad - k), n_features, device=dev)], 2)
    if sel:
        out.update({"hist_src": bins, "feats": feats.to(torch.int32).contiguous(), "d_pad": d_pad,
                    "n_features": n_features})
    else:
        out["hist_src"] = subset_bins(torch, bins, seg, feats)
    return out


def subset_bins(torch, bins, seg, feats):
    """Route B's (T, n, k_pad) uint8 bins: each row's node's columns
    gathered from the shared table (the builder's ``make_hist_src``)."""
    T, n = seg.shape
    n_nodes, k_pad = feats.shape[1:]
    rows = feats.gather(1, seg.clamp(max=n_nodes - 1)[..., None].expand(T, n, k_pad)).long()
    return bins.expand(T, n, bins.shape[1]).gather(2, rows.clamp(max=bins.shape[1] - 1))


# K5 per node at the GBT's level 7, H100 80GB HBM3 at 700 W: a quarter of
# the 8 x 0.1673 ms the per-sub-block launches took for the same level on
# that card (PERF.md §6)
NODE_HIST_MS_MAX = 0.335
# the per-sub-block K5 at the bench forest's level 12 on that card
SUBBLOCK_HIST_BENCH_MS = 0.7129


# K5's four main-path shapes (keys of phase_rf_kernels' results): the bench
# forest's levels 12 and 2, the regressor's level 12, the GBT's level 7
NODE_HIST_SHAPES = ("node_hist_batched", "node_hist_level2", "node_hist_variance", "node_hist_gbt")


def node_hist_gates(res) -> dict:
    """K5's gates: faster than its plain version and its library calls at
    the four main shapes, within NODE_HIST_MS_MAX at the GBT's level 7, and
    faster than the per-sub-block form's SUBBLOCK_HIST_BENCH_MS at the
    bench forest's level 12."""
    out = {}
    for k in NODE_HIST_SHAPES:
        out[f"{k}_beats_plain"] = res[k]["ms"] < res[k]["plain_ms"]
        out[f"{k}_beats_library"] = res[k]["ms"] < res[k]["library_ms"]
    out["gbt_level7_within_max"] = res["node_hist_gbt"]["ms"] <= NODE_HIST_MS_MAX
    out["bench_level12_beats_subblock_form"] = res["node_hist_batched"]["ms"] < SUBBLOCK_HIST_BENCH_MS
    return out


# K6's three timed shapes (keys of sel_levels' results)
NODE_HIST_SEL_SHAPES = ("node_hist_sel_batched", "node_hist_sel_level2", "node_hist_sel_ref")


def node_hist_sel_gates(res) -> dict:
    """K6's gates: faster than route B (the subset gather and K5) and than
    its library calls at its three timed shapes, in the same run."""
    out = {}
    for k in NODE_HIST_SEL_SHAPES:
        out[f"{k}_beats_route_b"] = res[k]["ms"] < res[k]["route_b_ms"]
        out[f"{k}_beats_library"] = res[k]["ms"] < res[k]["library_ms"]
    return out


def node_hist_args(inp):
    """K5's (bins, src2, swq, pstart) of a level's inputs."""
    T, n_pad, S = inp["T"], inp["n_pad"], inp["S"]
    return inp["hist_src"], inp["src2"], inp["sw"].reshape(T, n_pad, S), inp["pstart"]


def _last_weighted_row_of_span(torch, rk, bins, src2, swq, pstart, nb, r_sub):
    """(tree, row) of the last row in the first span of tree 0's middle
    non-empty node that carries weight into some bin (a bin < nb): the row
    a kernel that drops a span's last row would lose."""
    a = rk.span_subblocks(r_sub)
    ps = pstart[0].tolist()
    n_nodes = len(ps) - 1
    table = bins[0] if bins.dim() == 3 else bins
    for j in list(range(n_nodes // 2, n_nodes)) + list(range(n_nodes // 2)):
        lo, hi = ps[j], min(ps[j + 1], ps[j] + a * r_sub)
        if hi <= lo:
            continue
        w = (swq[0, lo:hi].abs().sum(dim=1) > 0) & (table.index_select(0, src2[0, lo:hi]) < nb).any(dim=1)
        if bool(w.any()):
            return 0, lo + int(torch.nonzero(w)[-1, 0])
    fail("no weighted row in any span")


def ragged_node_hist_inputs(torch, pt, g, T, n, n_nodes, F, S, nb, r_sub, per_tree, integer, empty):
    """K5 per-node inputs off the main path: ``empty`` of the nodes hold no
    rows, a tenth of the rows are in none, uint8 bins over all 256 values
    (those >= nb add nothing), Poisson(1) or Gaussian weights."""
    dev = g.device
    p = torch.rand(n_nodes, generator=g, device=dev) + 0.05
    p[torch.randperm(n_nodes, generator=g, device=dev)[:int(empty * n_nodes)]] = 0.0
    p = torch.cat([0.9 * p / p.sum(), torch.full((1,), 0.1, device=dev)])
    seg = torch.multinomial(p, T * n, replacement=True, generator=g).reshape(T, n)
    n_pad = -(-(n + (n_nodes + 1) * r_sub) // r_sub) * r_sub
    src2, pvalid, _, _, pstart = pt._compact_layout(seg, n_nodes, r_sub, n_pad)
    bins = torch.randint(0, 256, (T, n, F) if per_tree else (n, F), generator=g, device=dev, dtype=torch.uint8)
    sw = (torch.poisson(torch.ones((T, n, S), device=dev), generator=g) if integer
          else torch.randn((T, n, S), generator=g, device=dev))
    swq = sw.gather(1, src2[..., None].expand(T, n_pad, S)) * pvalid[..., None]
    return {"T": T, "n": n, "n_pad": n_pad, "r_sub": r_sub, "S": S, "nb": nb, "k_pad": F, "n_nodes": n_nodes,
            "hist_src": bins, "src2": src2, "sw": swq.reshape(T * n_pad, S).contiguous(), "pstart": pstart}


def ragged_node_hist_checks(torch, rk, pt, g):
    """K5 per node off the main path, each case with its control: nb in
    {32, 128, 255}, odd r_sub, bins past nb, empty nodes, nodes longer than
    one span, per-tree and shared tables, slot counts off the 16-byte rows
    (F = 11, 40) and on them (F = 32, 48)."""
    for T, n, nodes, F, S, nb, r_sub, per_tree, integer in (
            (3, 30_000, 5, 11, 5, 32, 24, True, True), (1, 40_000, 6, 40, 3, 255, 7, False, False),
            (2, 50_000, 4, 48, 2, 255, 9, False, True), (2, 40_000, 8, 32, 4, 128, 5, True, False)):
        inp = ragged_node_hist_inputs(torch, pt, g, T, n, nodes, F, S, nb, r_sub, per_tree, integer, 0.3)
        r = check_node_hist(torch, rk, inp, 0, exact=integer, control=True)
        check(r["multi_span_nodes"] > 0 and bool((inp["pstart"][:, 1:] == inp["pstart"][:, :-1]).any()),
              "a ragged K5 case lacks a node longer than one span or an empty node")
        emit({"phase": "kernels", "kernel": "node_hist_batched", "ragged": True, **r})


def ragged_node_hist_sel_checks(torch, rk, pt, g):
    """K6 off the main path, every case launched with both controls:
    n_features == d_pad (the sentinel past the row) with S = 3 real-valued
    stats, nb in {32, 128, 255}, rows of 200 bytes (not a multiple of 16),
    a table 4 bytes off 16-byte alignment, T = 1, empty nodes, nodes of
    many spans, ids sharing words and sentinels repeating, a tile across a
    slot boundary (S = 3)."""
    for T, n, nodes, d_row, n_feat, k, S, nb, r_sub, integer, off in (
            (2, 30_000, 6, 200, 200, 13, 3, 255, 24, False, 0),
            (1, 40_000, 5, 4096, 3000, 55, 2, 32, 16, True, 0),
            (3, 20_000, 4, 1024, 1000, 20, 2, 128, 8, True, 4),
            (2, 40_000, 8, 64, 60, 20, 4, 255, 5, True, 0),
            (2, 30_000, 6, 1024, 1000, 30, 3, 128, 7, True, 0)):
        inp = ragged_node_hist_inputs(torch, pt, g, T, n, nodes, d_row, S, nb, r_sub, False, integer, 0.3)
        if off:
            store = torch.empty(n * d_row + off, dtype=torch.uint8, device=g.device)
            store[off:] = inp["hist_src"].reshape(-1)
            inp["hist_src"] = store[off:].view(n, d_row)
        k_pad = pt.next_pow2(k)
        feats = torch.rand((T, nodes, n_feat), generator=g, device=g.device).argsort(dim=2)[..., :k]
        feats = torch.cat([feats, torch.full((T, nodes, k_pad - k), n_feat, device=g.device)], 2)
        inp.update({"feats": feats.to(torch.int32).contiguous(), "k": k, "k_pad": k_pad, "d_pad": d_row,
                    "n_features": n_feat})
        r = check_node_hist(torch, rk, inp, 0, exact=integer, control=True)
        check(r["multi_span_nodes"] > 0 and bool((inp["pstart"][:, 1:] == inp["pstart"][:, :-1]).any()),
              "a ragged K6 case lacks a node longer than one span or an empty node")
        emit({"phase": "kernels", "kernel": "node_hist_sel_batched", "ragged": True, "table_offset": off, **r})


def node_sectors(torch, feats, d_row):
    """(T, n_nodes) distinct 32-byte sectors of a row that each node's ids
    inside [0, d_row) touch: what K6 must read of each of its rows."""
    sec = torch.where((feats >= 0) & (feats < d_row), feats.long() >> 5, torch.full_like(feats.long(), -1))
    sec = sec.sort(dim=-1).values
    return (sec[..., :1] >= 0).sum(-1) + ((sec[..., 1:] != sec[..., :-1]) & (sec[..., 1:] >= 0)).sum(-1)


def check_node_hist(torch, rk, inp, reps, exact=True, control=False, cpu_bitwise=False, fold_control=False):
    """K5 per node, or K6 where the level gives each node's ids ``feats``,
    against its plain version in f64 on the same inputs: equal
    for integer stats, else within ``held`` of the f64 sums (T = the plain
    version over |swq|, n = the rows of the longest node). Two launches
    must give the same bits. ``control``: the last weighted row of one
    span dropped, and (K6) one node's first slot read at another feature
    id, which the check must catch. ``cpu_bitwise``: the f32 output equal
    bit for bit to the plain version on the host (the same inputs copied
    there); ``fold_control``: that plain version with each node's spans
    folded in reverse order, which the bitwise comparison must refuse (the
    f64 band alone does not). K6 is timed beside route B (each row's
    node's columns gathered, then K5 over them) and its library calls."""
    bins, src2, swq, pstart = node_hist_args(inp)
    feats = inp.get("feats")
    sel = feats is not None
    T, n_pad, S, nb, r_sub = inp["T"], inp["n_pad"], inp["S"], inp["nb"], inp["r_sub"]
    F, n_nodes = (feats if sel else bins).shape[-1], pstart.shape[1] - 1
    kw = dict(n_bins=nb, r_sub=r_sub)
    extra = (feats,) if sel else ()
    if sel:
        name, plain, vec = "node_hist_sel_batched", rk.node_hist_sel_plain, False
        geo = rk.node_hist_sel_geometry(T, n_pad, r_sub, n_nodes, F, S, nb)

        def kern():
            return rk.node_hist_sel_batched(bins, src2, swq, pstart, feats, **kw)
    else:
        name, plain, vec = "node_hist_batched", rk.node_hist_plain, F % 16 == 0 and bins.data_ptr() % 16 == 0
        geo = rk.node_hist_geometry(T, n_pad, r_sub, n_nodes, F, S, nb, vec)

        def kern():
            return rk.node_hist_batched(bins, src2, swq, pstart, **kw)
    out = kern()
    again = kern()
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(out, again))
    del again
    a = geo.a
    sbs = (pstart // r_sub).cpu()
    spans = ((sbs[:, 1:] - sbs[:, :-1] + a - 1) // a).clamp_min(1)
    multi = spans > 1
    longest = int((pstart[:, 1:] - pstart[:, :-1]).max())
    res = {key: inp[key] for key in ("T", "level", "n", "n_pad", "r_sub", "S", "nb", "k", "k_pad", "d_pad")
           if key in inp}
    res.update({"F": F, "n_nodes": n_nodes, "repeatable": repeatable, "span_rows": rk.SPAN_ROWS, "a": a,
                "spans": int(spans.sum()), "multi_span_nodes": int(multi.sum()),
                "partial_spans": int(spans[multi].sum()), "longest_node_rows": longest,
                "geometry": geo._asdict(), "tiles": -(-(S * geo.fc) // geo.P),
                "launches_a_level": -(-F // geo.fc)})

    def tree(t, x=None, f=None):
        # tree t's inputs (its weights replaced by x, its ids by f): the f64
        # references go a tree at a time, so that the largest level's fit
        # the card
        ids = (feats[t:t + 1] if f is None else f,) if sel else ()
        return ((bins[t:t + 1] if bins.dim() == 3 else bins), src2[t:t + 1],
                swq[t:t + 1].double() if x is None else x, pstart[t:t + 1], *ids)

    def verdict(o, t):
        # (max abs err, err/tol, holds) of o against tree t's f64 reference
        ref = plain(*tree(t), **kw)
        if exact:
            # integer sums below 2^24: the f64 reference is exact in f32 too
            return float((o.double() - ref).abs().max()), 0.0, bool(torch.equal(o, ref.float()))
        T_abs = plain(*tree(t, swq[t:t + 1].double().abs()), **kw)
        e, ratio = held(torch, o, ref, T_abs, longest)
        return e, ratio, ratio <= 1.0

    err, ratio, ok = 0.0, 0.0, True
    for t in range(T):
        e, r_, o_ = verdict(out[t:t + 1], t)
        err, ratio, ok = max(err, e), max(ratio, r_), ok and o_
    check(ok and repeatable, f"{name} T={T} n_pad={n_pad} F={F} S={S} nb={nb} r_sub={r_sub}: "
          f"max err {err}, err/tol {ratio:.3g}, repeatable {repeatable}")
    res.update({"max_abs_err": err, "err_over_tol": ratio, "exact": exact})
    controls = []
    if control:
        t, r = _last_weighted_row_of_span(torch, rk, bins, src2, swq, pstart, nb, r_sub)
        bad_sw = swq[t:t + 1].double().clone()
        bad_sw[0, r] = 0.0
        bad = plain(*tree(t, bad_sw), **kw)
        caught = not verdict(bad, t)[2]
        check(caught, f"the {name} check does not catch a span's dropped row")
        controls.append({"control": f"tree {t} row {r} (last weighted row of its span) dropped", "caught": caught})
        if sel:
            # that row's node reads its first slot at the next feature id
            j = int(torch.searchsorted(pstart[t, 1:], torch.tensor(r, device=pstart.device), right=True))
            bad_f = feats[t:t + 1].clone()
            bad_f[0, j, 0] = (bad_f[0, j, 0] + 1) % inp["n_features"]
            bad = plain(*tree(t, f=bad_f), **kw)
            caught = not verdict(bad, t)[2]
            check(caught, f"the {name} check does not catch a slot read at a wrong feature id")
            controls.append({"control": f"tree {t} node {j} slot 0 read at feature {int(bad_f[0, j, 0])}",
                             "caught": caught})
        del bad, bad_sw
    if cpu_bitwise:
        host = [x.cpu() for x in (bins, src2, swq, pstart, *extra)]
        if sel:
            sums, span_node = rk._span_scatter(rk.select_rows_plain(host[0], host[1], host[3], host[4]), host[2],
                                               host[3], nb, r_sub)
        else:
            sums, span_node = rk.span_sums_plain(*host, **kw)
        cpu = rk.fold_spans(sums, span_node, T * n_nodes).reshape(out.shape)
        res["equal_cpu_plain"] = bool(torch.equal(out.cpu(), cpu))
        check(res["equal_cpu_plain"], f"{name} differs from the CPU plain version bit for bit")
        if fold_control:
            rev = rk.fold_spans(sums.flip(0), span_node.flip(0), T * n_nodes).reshape(out.shape)
            caught = not bool(torch.equal(out.cpu(), rev))
            band = max(verdict(rev[t:t + 1].to(out.device), t)[1] for t in range(T))
            check(caught, "the bitwise comparison does not catch a node's spans folded in reverse order")
            controls.append({"control": "each node's spans folded in reverse order (CPU plain version)",
                             "caught": caught, "entries_differ": int((out.cpu() != rev).sum()),
                             "band_err_over_tol": band, "caught_by_band": band > 1.0})
            del rev
        del sums, span_node, cpu, host
    if controls:
        res["controls"] = controls
    if reps:
        res["ms"] = cuda_ms(torch, kern, reps)
        res["plain_ms"] = cuda_ms(torch, lambda: plain(bins, src2, swq, pstart, *extra, **kw), reps)
        dev = src2.device
        if sel:
            # route B: the rows' node columns gathered, then K5 over them
            seg = inp["seg"]
            res["route_b_gather_ms"] = cuda_ms(torch, lambda: subset_bins(torch, bins, seg, feats), reps)
            sub = subset_bins(torch, bins, seg, feats)
            res["route_b_node_hist_ms"] = cuda_ms(
                torch, lambda: rk.node_hist_batched(sub, src2, swq, pstart, **kw), reps)
            del sub
            res["route_b_ms"] = cuda_ms(torch, lambda: rk.node_hist_batched(
                subset_bins(torch, bins, seg, feats), src2, swq, pstart, **kw), reps)
        # the library calls: one gather of the rows' bins (K6: of their
        # selected bins), one scatter_add_ onto the (node, s, slot, bin)
        # index of those bins
        if sel:
            pos = torch.arange(n_pad, device=dev).expand(T, -1).contiguous()
            node_row = torch.searchsorted(pstart[:, 1:].contiguous(), pos, right=True).clamp(max=n_nodes - 1)
            table = bins.reshape(-1)
            rows_idx = (src2[..., None] * bins.shape[1]
                        + feats.gather(1, node_row[..., None].expand(T, n_pad, F)).long().clamp(0, bins.shape[1] - 1))
            del pos, node_row
            b = table[rows_idx].long()
        elif bins.dim() == 2:
            table, rows_idx = bins, src2.reshape(-1)
            b = table.index_select(0, rows_idx).long().reshape(T, n_pad, F)
        else:
            table = bins.reshape(-1, F)
            rows_idx = (src2 + torch.arange(T, device=dev)[:, None] * bins.shape[1]).reshape(-1)
            b = table.index_select(0, rows_idx).long().reshape(T, n_pad, F)
        sb = torch.arange(n_pad // r_sub, device=dev).expand(T, -1).contiguous()
        node = torch.searchsorted((pstart[:, 1:] // r_sub).contiguous(), sb, right=True)
        node = torch.where(node < n_nodes, node + torch.arange(T, device=dev)[:, None] * n_nodes, T * n_nodes)
        node = node.repeat_interleave(r_sub, dim=1)
        vals = torch.where((b < nb)[:, :, None, :], swq[..., None], torch.zeros((), device=dev)).reshape(-1)
        # in place: the largest level's index is 10 GB
        idx = ((node[..., None] * S + torch.arange(S, device=dev))[..., None] * F + torch.arange(F, device=dev))
        idx = idx.mul_(nb).add_(b.clamp_(max=nb - 1)[:, :, None, :]).reshape(-1)
        size = (T * n_nodes + 1) * S * F * nb
        del b, sb, node

        def library():
            rows = table[rows_idx] if sel else table.index_select(0, rows_idx)
            return rows, torch.zeros(size, device=dev).scatter_add_(0, idx, vals)

        res["library_ms"] = cuda_ms(torch, library, reps)
        res["library_calls"] = ("gather of the selected bins + scatter_add_ (two calls)" if sel
                                else "index_select + scatter_add_ (two calls)")
        del idx, vals, rows_idx
        # the rows read through src2 (K5: the 32-byte sectors of F bytes;
        # K6: the distinct sectors of the node's ids), src2 and swq, the node
        # histograms written, and the span partials written and read
        rows_node = (pstart[:, 1:] - pstart[:, :-1]).double()
        rows_read = int(rows_node.sum())
        if sel:
            row_bytes = float((rows_node * 32 * node_sectors(torch, feats, bins.shape[1])).sum())
            res["sectors_a_row"] = row_bytes / 32 / rows_read
        else:
            row_bytes = rows_read * 32.0 * -(-F // 32)
        hist_bytes = 4.0 * S * F * nb
        nbytes = (row_bytes + rows_read * (8 + 4 * S) + hist_bytes * T * n_nodes
                  + 2 * hist_bytes * res["partial_spans"])
        res["bytes"] = nbytes
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, float(rows_read) * S * F)
        res["attributes"] = dict(zip(("registers", "local_bytes", "blocks_per_sm"),
                                     rk.node_hist_attributes(vec, geo.P, geo.smem, sel=sel)))
    del out
    return res


def random_forest(rng, T, depth, d, nb, leaf_p=0.15):
    """(feat, thr_bin) of T random heap-ordered trees of depth ``depth``:
    every node of the top levels splits, a fraction ``leaf_p`` of the deeper
    ones is an early leaf (and its subtree with it)."""
    M = (1 << (depth + 1)) - 1
    feat = rng.integers(0, d, size=(T, M)).astype(np.int32)
    early = rng.random((T, M)) < leaf_p
    early[:, :7] = False
    early[:, (1 << depth) - 1:] = True
    feat[early] = -1
    for i in range(1, (1 << depth) - 1):
        feat[feat[:, (i - 1) // 2] < 0, i] = -1
    thr = rng.integers(0, nb - 1, size=(T, M)).astype(np.int32)
    return feat, thr


# the route K9 replaced (hop 1 in plain PyTorch, the previous kernel's hop
# 2, the per-tree payload gathers and adds) at the bench forest's batch,
# device ms by CUDA events on the checkout before K9's redesign (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6); the one-launch kernel must
# be faster
ROUTE_MS_STEP0_RUN_A = 5.378
# K9's timed shapes: (key, rows, bytes a row, trees, depth, payload width
# V), each a transform batch: the bench forest, rf_wide's forest, the GBT
# classifier's and the reference's RandomForestRegressor (k2 = 0)
K9_SHAPES = (("packed_forest_eval", RF_ROWS, E2E_D, RF_TREES, RF_DEPTH, 2),
             ("packed_forest_eval_wide", RF_ROWS, RF_WIDE_D, RF_SMALL_TREES, RF_DEPTH, 2),
             ("packed_forest_eval_gbt", RF_ROWS, E2E_D, GBT_ROUNDS, GBT_DEPTH, 1),
             ("packed_forest_eval_regressor_ref", RF_ROWS, E2E_D, RF_REF_REG_TREES, RF_REF_REG_DEPTH, 1))
# K9's ragged shapes, held only: two tree groups and padding trees on a
# ragged last tile, the generic payload instance (V > 8), one row, rows too
# wide to stage (read from global memory) with V = 2 and V = 10
K9_RAGGED = (("t11_ragged", RF_ROWS - 1, E2E_D, 11, 10, 3), ("generic_v10", 4096, E2E_D, 11, RF_DEPTH, 10),
             ("one_row", 1, E2E_D, RF_TREES, RF_DEPTH, 2), ("unstaged", 4097, 8192, 11, RF_DEPTH, 2),
             ("unstaged_v10", 4097, 8192, 11, RF_DEPTH, 10))


def leaf_steps(torch, leaf, T, skip=0):
    """The walk's steps in this run's data: each real tree's leaf depth
    (floor(log2(id + 1))) over the rows, less ``skip`` levels a walk that
    passed them."""
    depth = torch.floor(torch.log2(leaf[:, :T].double() + 1))
    return float((depth - skip).clamp_min(0).sum())


def check_packed_forest(torch, rk, pt, xb, feat, thr, depth, values, reps, control=False):
    """K9 on one transform batch, bit for bit (tolerance 0: the walk is
    integer, and the sums are the plain route's f32 adds in the same
    order, so no f64 band is needed): ROOT + SUM (``packed_forest_eval``
    with ``values``) against the plain route on the card (hop 1 as gathers,
    hop 2, the payload sum); ROOT + LEAF against hop 1 + hop 2 plain; I1 +
    LEAF (``packed_traverse``, the TPU kernel's contract) against its plain
    hop 2. Controls, each run through the kernel and required to move its
    output: one hop-2 threshold moved (LEAF), one hop-1 threshold moved
    (LEAF: hop 1 runs in the kernel), one leaf payload changed (SUM)."""
    pf = pt.pack_forest(feat, thr, max_depth=depth)
    dev = xb.device
    f1, t1, f2, t2 = (torch.from_numpy(a).to(dev) for a in (pf.feat1, pf.thr1, pf.feat2, pf.thr2))
    w1, w2 = pt.packed_node_tables(pf, dev)
    packed = pt.pack_bins(xb)
    n, t_pad, T, V = xb.shape[0], pf.feat1.shape[0], feat.shape[0], values.shape[2]
    k1, k2 = pf.k1, pf.k2
    tag = f"packed_forest_eval {n}x{xb.shape[1]} T={T} k1={k1} k2={k2} V={V}"

    def held(what, out, ref):
        differ = int((out != ref).sum())
        check(differ == 0, f"{tag}: {what}: {differ} entries differ from the plain version")
        return differ

    raw = rk.packed_forest_eval(packed, w1, w2, values, k1=k1, k2=k2)
    raw_ref = rk.packed_forest_eval_plain(packed, w1, w2, values, k1=k1, k2=k2)
    leaf = rk.packed_forest_eval(packed, w1, w2, k1=k1, k2=k2)
    i1 = rk._packed_hop1(xb, f1, t1, k1=k1)
    leaf_ref = i1 if k2 == 0 else rk.packed_traverse_plain(packed, i1, f2, t2, k1=k1, k2=k2)
    torch.cuda.synchronize()
    res = {"rows": n, "d_pad": xb.shape[1], "words": packed.shape[1], "trees": T, "t_pad": t_pad, "depth": depth,
           "k1": k1, "k2": k2, "V": V, "stage": rk._forest_geometry(packed.shape[1], k1, True)[0],
           "sum_differ": held("ROOT + SUM", raw, raw_ref), "leaf_differ": held("ROOT + LEAF", leaf, leaf_ref),
           "max_abs_err": float((raw - raw_ref).abs().max()), "tolerance": 0}
    if k2:
        res["i1_leaf_differ"] = held("I1 + LEAF", rk.packed_traverse(packed, i1, f2, t2, k1=k1, k2=k2), leaf_ref)
    n1 = (1 << k1) - 1
    res["rows_past_hop1"] = float((i1[:, :T] >= n1).float().mean())
    if control:
        ctl = []
        if k2:
            # tree 0's busiest hop-2 subtree whose root splits: its rows sent
            # left (threshold 255), then right (-1)
            past = i1[:, 0].long() >= n1
            busy = torch.bincount(i1[past, 0].long() - n1, minlength=1 << k1)
            busy[f2[:1 << k1, 0] < 0] = 0
            row = int(busy.argmax())
            moved = 0
            for bad in (255, -1):
                bad_t2 = t2.clone()
                bad_t2[row, 0] = bad
                bad_w2 = rk.forest_nodes(f2, bad_t2)
                moved += int((rk.packed_forest_eval(packed, w1, bad_w2, k1=k1, k2=k2) != leaf).sum())
            ctl.append({"control": f"hop 2: tree 0, subtree {row} ({int(busy[row])} rows): root threshold 255, "
                                   "then -1", "leaf_ids_moved": moved})
        moved = 0
        for bad in (255, -1):
            bad_t1 = t1.clone()
            bad_t1[0, 0] = bad
            moved += int((rk.packed_forest_eval(packed, rk.forest_nodes(f1, bad_t1), w2, k1=k1, k2=k2) != leaf).sum())
        ctl.append({"control": "hop 1: tree 0's root threshold 255, then -1", "leaf_ids_moved": moved})
        # the leaf of tree 0 that most rows reach: its first payload + 1
        top = int(torch.bincount(leaf[:, 0].long()).argmax())
        bad_v = values.clone()
        bad_v[0, top, 0] += 1.0
        moved = int((rk.packed_forest_eval(packed, w1, w2, bad_v, k1=k1, k2=k2) != raw).sum())
        ctl.append({"control": f"payload: tree 0, leaf {top}, first value + 1", "raw_moved": moved})
        for c in ctl:
            check(c.get("leaf_ids_moved", c.get("raw_moved")) > 0, f"{tag}: the K9 control ({c['control']}) "
                  "moves nothing")
        res["controls"] = ctl
    if reps:
        # device time (calls queued behind a device wait: the wrapper's host
        # time a call is longer than the kernel) and host µs a call apart
        steps = leaf_steps(torch, leaf, T)
        rows_b = 4.0 * packed.numel()
        tables = 4.0 * (w1.numel() + w2.numel())
        # ~10 integer operations a step of a walk, at the FP32 rate
        nbytes = rows_b + tables + 4.0 * values.numel() + 4.0 * n * V
        res.update(bytes=nbytes, steps=steps)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 10.0 * steps)
        res["ms"], res["host_us"] = device_host(
            torch, lambda: rk.packed_forest_eval(packed, w1, w2, values, k1=k1, k2=k2), reps)
        res["plain_ms"] = cuda_ms(torch, lambda: rk.packed_forest_eval_plain(packed, w1, w2, values, k1=k1, k2=k2),
                                  reps)
        res["library_ms"] = None  # none: no single PyTorch call walks the packed forest
        nbytes = rows_b + tables + 4.0 * n * t_pad
        res["leaf"] = {"bytes": nbytes, **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, 10.0 * steps))),
                       "ms": device_host(torch, lambda: rk.packed_forest_eval(packed, w1, w2, k1=k1, k2=k2), reps)[0]}
        if k2:
            # the TPU kernel's contract: i1 read and the ids written; the
            # wrapper makes the node words of feat2/thr2 a call, the kernel
            # alone (kernel_ms) takes them made
            nbytes = 4.0 * (packed.numel() + 2 * n * t_pad + w2.numel())
            steps2 = leaf_steps(torch, leaf, T, skip=k1)
            res["i1"] = {"bytes": nbytes, "steps": steps2,
                         **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, 10.0 * steps2))),
                         "ms": device_host(torch, lambda: rk.packed_traverse(packed, i1, f2, t2, k1=k1, k2=k2),
                                           reps)[0],
                         "kernel_ms": device_host(torch, lambda: rk._forest_launch(packed, t_pad, k1, k2, w2, i1=i1),
                                                  reps)[0],
                         "plain_ms": cuda_ms(torch, lambda: rk.packed_traverse_plain(packed, i1, f2, t2, k1=k1,
                                                                                    k2=k2), reps),
                         "library_ms": None}
    return res


def k9_inputs(torch, pt, g, rng, n, d, T, depth, V, bins=None):
    """(bins, feat, thr, values) of one K9 case: random bins of n rows of
    d bytes from ``g`` (or ``bins``), a random forest (``random_forest``)
    and a random (T, nodes, V) payload."""
    if bins is None:
        bins = torch.randint(0, RF_BINS, (n, d), generator=g, device=g.device, dtype=torch.uint8)
    feat, thr = random_forest(rng, T, depth, d, RF_BINS)
    values = torch.rand((T, feat.shape[1], V), generator=g, device=g.device)
    return bins, feat, thr, values


def phase_k9(torch, rk, pt, g, rng, reps, bench_bins=None):
    """K9 at its timed shapes (K9_SHAPES; the bench forest on ``bench_bins``
    where given), each held with its controls and timed, the route gate at
    the bench shape, then the ragged shapes (K9_RAGGED) held. Returns
    {key: result}."""
    res = {}
    for key, n, d, T, depth, V in K9_SHAPES:
        bins = bench_bins if key == "packed_forest_eval" and bench_bins is not None else None
        inp = k9_inputs(torch, pt, g, rng, n, d, T, depth, V, bins)
        res[key] = check_packed_forest(torch, rk, pt, *inp[:3], depth, inp[3], reps, control=True)
        emit({"phase": "kernels", "kernel": "packed_forest_eval", "shape": key, **res[key]})
        del inp
        torch.cuda.empty_cache()
    bench = res["packed_forest_eval"]
    gate = bench["ms"] < ROUTE_MS_STEP0_RUN_A
    emit({"phase": "kernels", "kernel": "packed_forest_eval", "route_ms_step0_run_A": ROUTE_MS_STEP0_RUN_A,
          "ms": bench["ms"], "faster_than_step0_route": gate})
    check(gate, f"K9 at the bench shape: {bench['ms']:.4f} ms, not faster than step 0's route "
                f"({ROUTE_MS_STEP0_RUN_A} ms)")
    for key, n, d, T, depth, V in K9_RAGGED:
        inp = k9_inputs(torch, pt, g, rng, n, d, T, depth, V)
        emit({"phase": "kernels", "kernel": "packed_forest_eval", "ragged": key,
              **check_packed_forest(torch, rk, pt, *inp[:3], depth, inp[3], 0, control=n > 1)})
        del inp
    torch.cuda.empty_cache()
    return res


def hop2_indices(torch, pt, xb, feat, thr, depth):
    """The (G, n, 2^k2 - 1) int32 byte indices the bins engine gives K8 for
    one group of trees: each row's hop-2 table row, selected by its own
    hop 1 (``tree_kernels._hop2_rows``)."""
    k1, k2 = pt._split_depths(depth)
    f, t = torch.from_numpy(feat).to(xb.device).long(), torch.from_numpy(thr).to(xb.device).long()
    return torch.stack([pt._hop2_rows(xb, f[i], t[i], k1=k1, k2=k2)[5] for i in range(f.shape[0])]).to(torch.int32)


def check_byte_gather(torch, rk, packed, idx, reps, control=False, single=False):
    """K8 (K7 with ``single``: the first index set alone) against its plain
    version: integer bytes, equal. The control flips one output byte,
    which the check must catch. Library: one ``torch.gather`` on the
    rows' byte view with an int64 index made beforehand (the index
    conversion is not timed)."""
    if single:
        idx = idx[0]
        kern, plain = rk.packed_byte_gather, rk.packed_byte_gather_plain
    else:
        kern, plain = rk.packed_byte_gather_many, rk.packed_byte_gather_many_plain
    out = kern(packed, idx)
    ref = plain(packed, idx)
    torch.cuda.synchronize()
    n, words = packed.shape
    G, k = (1, idx.shape[1]) if single else (idx.shape[0], idx.shape[2])
    differ = int((out != ref).sum())
    check(differ == 0, f"{kern.__name__} n={n} words={words} G={G} k={k}: {differ} bytes differ")
    outside = int(((idx < 0) | (idx >= 4 * words)).sum())
    # a package from before K7/K8's routing (a parent checkout, timed in the
    # same call for a before/after comparison) has no geometry to report
    routed = hasattr(rk, "gather_geometry")
    res = {"rows": n, "words": words, "G": G, "k": k, "max_abs_err": 0, "bytes_differ": differ,
           "out_of_range_indices": outside,
           "variant": rk.gather_geometry(packed, idx)._asdict() if routed else "one thread an entry"}
    if control:
        bad = out.clone().view(-1)
        pos = bad.numel() // 2 + 1
        bad[pos] ^= 1
        caught = not bool(torch.equal(bad.view(out.shape), ref))
        check(caught, f"the {kern.__name__} check does not catch a flipped output byte")
        res["controls"] = [{"control": f"output entry {pos}: lowest bit flipped", "caught": caught}]
        del bad
    if reps:
        # ms: events around back-to-back calls (the host may set their
        # pace); device_ms / host_us: the same calls split (device_host)
        call = lambda: kern(packed, idx)  # noqa: E731
        res["ms"] = cuda_ms(torch, call, GATHER_REPS)
        res["device_ms"], res["host_us"] = device_host(torch, call, GATHER_REPS)
        res["timed_calls"] = GATHER_REPS
        res["plain_ms"] = cuda_ms(torch, lambda: plain(packed, idx), reps)
        pb = packed.view(torch.uint8)                    # (n, 4·words), little-endian bytes
        i64 = idx.long()
        src = pb if single else pb.unsqueeze(0).expand(G, n, 4 * words)
        library = lambda: torch.gather(src, src.dim() - 1, i64)  # noqa: E731
        res["library_ms"] = cuda_ms(torch, library, GATHER_REPS)
        res["library_device_ms"], res["library_host_us"] = device_host(torch, library, GATHER_REPS)
        res["library_call"] = "torch.gather on the uint8 byte view, int64 index made beforehand"
        del i64
        # each instance that takes the shape, forced (device ms, host µs)
        res["instances"] = {}
        for staged in (True, False) if routed else ():
            try:
                geom = rk._gather_geometry(n, words, k, G, True, True, *gather_device(rk), staged=staged)
            except ValueError:
                continue
            res["instances"][geom.instance] = {"rows": geom.rows, "grid": geom.grid, **dict(zip(
                ("device_ms", "host_us"), device_host(torch, lambda: rk._launch_byte_gather(packed, idx, geom),
                                                      GATHER_REPS)))}
        # idx read once, out written once (int32 each), and of the rows the
        # 32-byte sectors (the card's unit of access) that the lookups touch:
        # what this run's indices need (at the GBT's k = 1 a row's 8 lookups
        # touch ~5 of its 8 sectors)
        inside = (idx >= 0) & (idx < 4 * words)
        row_at = torch.arange(n, device=idx.device).view(n, 1) * (4 * words)
        touched = int(torch.unique(((row_at + idx.long()) >> 5)[inside]).numel())
        nbytes = 4.0 * 2 * G * n * k + 32.0 * touched
        res["bytes"], res["touched_sectors"], res["row_sectors"] = nbytes, touched, -(-n * 4 * words // 32)
        # a shift, a mask, a compare pair and a select per output
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 5.0 * G * n * k)
    return res


def gather_device(rk):
    """(shared memory a block may opt into, SMs, resident blocks an SM) of
    cuda:0, as K7/K8's geometry takes them."""
    sms, smem, resident = rk._gather_device(0)
    return smem, sms, resident


def check_gather_instances(torch, rk, packed, idx, what):
    """Each instance of K8 that takes (packed, idx), forced, against the
    plain version: 0 bytes differ, and a flipped byte is caught."""
    if not hasattr(rk, "gather_geometry"):  # see check_byte_gather
        return
    G, n, k = idx.shape
    words = packed.shape[1]
    ref = rk.packed_byte_gather_many_plain(packed, idx)
    for staged in (True, False):
        try:
            geom = rk._gather_geometry(n, words, k, G, packed.data_ptr() % 16 == 0, idx.data_ptr() % 16 == 0,
                                       *gather_device(rk), staged=staged)
        except ValueError:  # the staged instance does not take these rows
            continue
        out = rk._launch_byte_gather(packed, idx, geom)
        torch.cuda.synchronize()
        differ = int((out != ref).sum())
        check(differ == 0, f"packed_byte_gather_many {what} ({geom.instance}): {differ} bytes differ")
        bad = out.view(-1).clone()
        bad[bad.numel() // 3] ^= 1 << 7
        caught = not bool(torch.equal(bad.view(out.shape), ref))
        check(caught, f"the {geom.instance} check does not catch a flipped output byte")
        emit({"phase": "kernels", "kernel": "packed_byte_gather_many", "ragged": what, "instance": geom._asdict(),
              "rows": n, "words": words, "G": G, "k": k, "bytes_differ": differ,
              "out_of_range_indices": int(((idx < 0) | (idx >= 4 * words)).sum()),
              "controls": [{"control": f"output entry {bad.numel() // 3}: bit 7 flipped", "caught": caught}]})


def ragged_gather_inputs(torch, rng, n, words, G, k, idx_offset=0, packed_offset=0):
    """Random packed rows and indices in [-1, 4·words], with 4·words (the
    sentinel past the row) and -1 planted; a nonzero offset makes the
    tensor a contiguous view that many entries into its storage."""
    pk = rng.integers(-2 ** 31, 2 ** 31, size=n * words + packed_offset, dtype=np.int64).astype(np.int32)
    ir = rng.integers(-1, 4 * words + 1, size=G * n * k + idx_offset).astype(np.int32)
    pk = torch.from_numpy(pk).cuda()[packed_offset:].view(n, words)
    ir = torch.from_numpy(ir).cuda()[idx_offset:].view(G, n, k)
    ir[:, ::7, 0] = 4 * words
    ir[:, ::5, -1] = -1
    return pk, ir


def sweep_gather(torch, rk, shape, packed, idx):
    """Device ms of each instance at chunk sizes R around the routed ones
    (a probe: ``--gather-only``), each held against the routed kernel."""
    from spark_rapids_ml_tpu_torch.ops import _build

    G, n, k = idx.shape
    words = packed.shape[1]
    smem_optin, sms, resident = gather_device(rk)
    occ = _build.function("rf_byte_gather", "packed_byte_gather_occupancy", [ctypes.c_int, ctypes.c_int,
                                                                              ctypes.c_void_p])
    ref = rk._launch_byte_gather(packed, idx)
    for instance in ("staged_vec", "direct_vec"):
        for R in (4, 8, 16, 24, 32, 48, 64, 96, 128, 256, 512):
            smem = 2 * R * 4 * words if instance == "staged_vec" else 0
            if smem > smem_optin or R * 8 > n:
                continue
            blocks = ctypes.c_int(0)
            _build.check("rf_byte_gather", occ(rk._GATHER_INSTANCES[instance], smem, ctypes.byref(blocks)))
            chunks = -(-n // R)
            for grid in sorted({min(chunks, sms * blocks.value), chunks}):
                geom = rk.GatherGeometry(instance, R, 2 if smem else 0, grid, smem)
                check(torch.equal(rk._launch_byte_gather(packed, idx, geom), ref), f"sweep {geom} differs")
                ms, _ = device_host(torch, lambda: rk._launch_byte_gather(packed, idx, geom), GATHER_REPS)
                emit({"probe": "sweep", "shape": shape, **geom._asdict(), "resident": blocks.value,
                      "device_ms": ms})


def phase_byte_gather_kernels(torch, bins, wide, reps, seed, sweep=False):
    """K8 (and K7) at the bins engine's shapes: the bench forest's (8
    depth-13 trees, k = 63, 64 words), the GBT's (8 depth-8 trees, k = 1),
    3,000 features (750 words), and ragged n, words, G and k with
    out-of-range indices. ``sweep``: also ``sweep_gather`` at the four
    timed shapes."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    rng = np.random.default_rng(seed + 17)
    res = {}
    packed = pt.pack_bins(bins)
    feat, thr = random_forest(rng, 8, RF_DEPTH, bins.shape[1], RF_BINS)
    idx = hop2_indices(torch, pt, bins, feat, thr, RF_DEPTH)

    def held_timed(key, kernel, shape, packed_rows, indices, single=False):
        res[key] = r = check_byte_gather(torch, rk, packed_rows, indices, reps, control=True, single=single)
        emit({"phase": "kernels", "kernel": kernel, "shape": shape, **r})
        if reps:  # the redesigned kernel must beat the plain version it replaces
            check(r["device_ms"] < r["plain_ms"],
                  f"{kernel} ({shape}) {r['device_ms']:.4f} ms not below its plain version's {r['plain_ms']:.4f} ms")
        if sweep:
            sweep_gather(torch, rk, shape, packed_rows, indices[:1] if single else indices)

    held_timed("packed_byte_gather_many", "packed_byte_gather_many", "rf_bench", packed, idx)
    held_timed("packed_byte_gather", "packed_byte_gather", "rf_bench_one_tree", packed, idx, single=True)
    feat, thr = random_forest(rng, 8, GBT_DEPTH, bins.shape[1], RF_BINS)
    idx = hop2_indices(torch, pt, bins, feat, thr, GBT_DEPTH)
    held_timed("packed_byte_gather_many_gbt", "packed_byte_gather_many", "gbt", packed, idx)
    xw = wide[:, :RF_WIDE_D].contiguous()
    feat, thr = random_forest(rng, 8, RF_DEPTH, RF_WIDE_D, RF_BINS)
    idx = hop2_indices(torch, pt, xw, feat, thr, RF_DEPTH)
    held_timed("packed_byte_gather_many_wide", "packed_byte_gather_many", "rf_wide", pt.pack_bins(xw), idx)
    del xw, idx
    # ragged: n, words, G and k off every block size (n·k % 4 != 0),
    # indices at 4·words (the sentinel past the row) and -1, which must
    # read 0; each instance forced, then the routed wrappers
    n_r, w_r, g_r, k_r = 10_007, 37, 3, 5
    pk, ir = ragged_gather_inputs(torch, rng, n_r, w_r, g_r, k_r)
    check_gather_instances(torch, rk, pk, ir, "n·k % 4 != 0")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, n_r, w_r, g_r, k_r, idx_offset=1),
                           "idx one entry into its storage")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 4_099, 64, 1, 1), "k = 1, G = 1")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 1_001, 7_300, 2, 7),
                           "7,300 words: past the staged cap")
    check_gather_instances(torch, rk, *ragged_gather_inputs(torch, rng, 2_001, 61, 2, 9, packed_offset=1),
                           "packed one word into its storage")
    r = check_byte_gather(torch, rk, pk, ir, 0, control=True)
    check(bool((rk.packed_byte_gather_many(pk, ir)[(ir < 0) | (ir >= 4 * w_r)] == 0).all()),
          "packed_byte_gather_many: an out-of-range index did not read 0")
    emit({"phase": "kernels", "kernel": "packed_byte_gather_many", "ragged": True, **r})
    emit({"phase": "kernels", "kernel": "packed_byte_gather", "ragged": True,
          **check_byte_gather(torch, rk, pk, ir, 0, single=True)})
    torch.cuda.synchronize()
    return res


def rf_bins(torch, pt, X_rf, seed):
    """The forest paths' (n, 256) uint8 bins of ``X_rf``."""
    edges = torch.from_numpy(pt.make_bin_edges(X_rf.cpu().numpy(), RF_BINS, seed=seed)).to(X_rf.device)
    return pt.binize(X_rf, edges, d_pad=E2E_D)


def wide_bins(torch, pt, n, g, seed):
    """(n, 4,096) uint8 bins of n Gaussian rows of 3,000 features, edges
    from about 16,384 of them."""
    Xw = torch.randn((n, RF_WIDE_D), generator=g, device=g.device)
    ew = torch.from_numpy(pt.make_bin_edges(Xw[::max(1, n // 16_384)].cpu().numpy(), RF_BINS, seed=seed))
    ew = ew.to(g.device)
    return pt.binize(Xw, ew, d_pad=pt.next_pow2(RF_WIDE_D))


def gbt_level_stats(torch, y, g):
    """The GBT classifier's (n, 4) logistic stats (w, r, r², h) at random
    margins."""
    p = torch.sigmoid(torch.randn(y.shape[0], generator=g, device=y.device))
    r = y - p
    return torch.stack([torch.ones_like(r), r, r * r, (p * (1 - p)).clamp_min(1e-12)], 1)


def sel_inputs(torch, pt, wide, cls, g):
    """K6's three timed shapes, one at a time, as (key, shape, level
    inputs): the 3,000-feature forest's levels 12 and 2 on the 131,072 rows
    ``wide`` with stats ``cls``, and level 12 of the reference's 1,000,000
    rows (bins and labels made on the card from ``g``)."""
    for key, lvl in (("node_hist_sel_batched", 12), ("node_hist_sel_level2", 2)):
        yield key, f"wide_level{lvl}", rf_level_inputs(torch, pt, wide, cls, lvl, RF_SMALL_TREES, RF_WIDE_K,
                                                       RF_WIDE_D, g, sel=True)
    ref = wide_bins(torch, pt, RF_WIDE_ROWS, g, 0)
    y = torch.randint(0, 2, (RF_WIDE_ROWS,), generator=g, device=g.device)
    yield "node_hist_sel_ref", "reference_rows_level12", rf_level_inputs(
        torch, pt, ref, torch.nn.functional.one_hot(y, 2).float(), 12, RF_SMALL_TREES, RF_WIDE_K, RF_WIDE_D, g,
        sel=True)


def sel_levels(torch, rk, pt, wide, cls, reps, g):
    """K6 at its three timed shapes (``sel_inputs``), each held with its
    controls and timed. Returns {key: result}."""
    res = {}
    for key, shape, inp in sel_inputs(torch, pt, wide, cls, g):
        res[key] = check_node_hist(torch, rk, inp, reps, control=True)
        emit({"phase": "kernels", "kernel": "node_hist_sel_batched", "shape": shape, **res[key]})
        del inp
        torch.cuda.empty_cache()
    return res


def phase_rf_kernels(torch, X_rf, y_rf, reps, seed):
    """K5, K6 and K9 at the shapes the forest paths give them, K5 at the
    GBT's deepest split level, and K8/K7 (``phase_byte_gather_kernels``)."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    dev = X_rf.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    n = X_rf.shape[0]
    bins = rf_bins(torch, pt, X_rf, seed)
    cls = torch.nn.functional.one_hot(y_rf.long(), 2).float()
    res = {}
    # K5 at the bench forest's deepest split level (12) and a shallow one
    inp = rf_level_inputs(torch, pt, bins, cls, 12, 8, 16, E2E_D, g)
    res["node_hist_batched"] = check_node_hist(torch, rk, inp, reps, control=True)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "shape": "bench_level12", **res["node_hist_batched"]})
    inp = rf_level_inputs(torch, pt, bins, cls, 2, 8, 16, E2E_D, g)
    res["node_hist_level2"] = check_node_hist(torch, rk, inp, reps)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "shape": "bench_level2", **res["node_hist_level2"]})
    # the regressor's level 12: S = 3 real-valued moments, k = 86 -> 128
    # slots
    yr = X_rf[:, :8].sum(dim=1) + 0.5 * torch.randn(n, generator=g, device=dev)
    reg = torch.stack([torch.ones_like(yr), yr, yr * yr], 1)
    inp = rf_level_inputs(torch, pt, bins, reg, 12, 8, 86, E2E_D, g)
    res["node_hist_variance"] = check_node_hist(torch, rk, inp, reps, exact=False, control=True)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "shape": "regressor_level12",
          **res["node_hist_variance"]})
    del inp
    torch.cuda.empty_cache()
    ragged_node_hist_checks(torch, rk, pt, g)
    # K6: the 3,000-feature forest's levels (k = 55 -> 64, d_pad 4,096) at
    # 131,072 rows and at the reference's 1,000,000
    wide = wide_bins(torch, pt, n, g, seed)
    res.update(sel_levels(torch, rk, pt, wide, cls, reps, g))
    ragged_node_hist_sel_checks(torch, rk, pt, g)
    # K9 at its four timed shapes (the bench forest on these bins) and the
    # ragged ones, its own draws
    g9 = torch.Generator(device=dev)
    g9.manual_seed(seed + 19)
    res.update(phase_k9(torch, rk, pt, g9, np.random.default_rng(seed + 19), max(reps, 10), bench_bins=bins))
    res.update(phase_byte_gather_kernels(torch, bins, wide, reps, seed))
    del wide
    torch.cuda.empty_cache()
    # K5 at the GBT's deepest split level (7 of depth 8): one tree, all 256
    # features in one launch, S = 4 logistic stats; equal to the CPU plain
    # version bit for bit there and at level 0 (one node of many spans,
    # where folding its spans in reverse order must be refused)
    logit = gbt_level_stats(torch, y_rf, g)
    inp = rf_level_inputs(torch, pt, bins, logit, GBT_DEPTH - 1, 1, E2E_D, E2E_D, g, depth=GBT_DEPTH,
                          bootstrap=False)
    res["node_hist_gbt"] = check_node_hist(torch, rk, inp, reps, exact=False, control=True, cpu_bitwise=True)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "shape": "gbt_level7", **res["node_hist_gbt"]})
    inp = rf_level_inputs(torch, pt, bins, logit, 0, 1, E2E_D, E2E_D, g, depth=GBT_DEPTH, bootstrap=False)
    res["node_hist_gbt_level0"] = check_node_hist(torch, rk, inp, reps, exact=False, cpu_bitwise=True,
                                                  fold_control=True)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "shape": "gbt_level0", **res["node_hist_gbt_level0"]})
    del inp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def staged_copy_s(torch, X):
    """Seconds of the copy a fit of host rows ``X`` starts with,
    ``shard_rows`` through the staging ring, on its own."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows

    placed, t = _timed(torch, lambda: shard_rows(X, torch.device("cuda:0")))
    del placed
    torch.cuda.empty_cache()
    return t


def phase_e2e(torch, X_host, y_host, seed):
    """PCA(k=16), KMeans(k=1024, maxIter=10) and LogisticRegression(
    maxIter=20) fit and transform on the host rows, each kernel counted.
    Returns the launches {kernel: n} and the KMeans model with its fit
    seconds."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    wrappers = {"shifted_gram": lin.shifted_gram, "lloyd_step": kk.lloyd_step,
                "logreg_loss_grad": lk.logreg_loss_grad}
    n = X_host.shape[0]
    df = DataFrame({"features": X_host, "label": y_host})
    # the host->device copy every fit starts with, on its own
    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows

    placed, t_h2d = _timed(torch, lambda: shard_rows(X_host, torch.device("cuda:0")))
    del placed
    emit({"phase": "e2e", "check": "host_to_device", "bytes": X_host.nbytes, "s": t_h2d,
          "gb_per_s": X_host.nbytes / t_h2d / 1e9})
    for w in wrappers.values():
        w.launches = 0

    pca = PCA(k=16)
    pm, t_fit = _timed(torch, lambda: pca.fit(df))
    out, t_tr = _timed(torch, lambda: pm.transform(df))
    proj = out.column("pca_features")
    evr = pm.explained_variance_ratio_
    check(proj.shape == (n, 16) and np.isfinite(proj).all(), "PCA transform not finite/shape")
    check(bool(((evr > 0) & (evr <= 1)).all()) and float(evr.sum()) <= 1.0 + 1e-5,
          f"PCA explained-variance ratios outside (0, 1]: {evr}")
    emit({"phase": "e2e", "estimator": "PCA", "k": 16, "rows": n, "fit_s": t_fit,
          "transform_s": t_tr, "fit_rows_per_s": n / t_fit, "transform_rows_per_s": n / t_tr,
          "explained_variance_ratio_sum": float(evr.sum()),
          "shifted_gram_launches": wrappers["shifted_gram"].launches})

    km = KMeans(k=E2E_CENTRES, maxIter=10, seed=seed)
    kmm, t_fit = _timed(torch, lambda: km.fit(df))
    out, t_tr = _timed(torch, lambda: kmm.transform(df))
    pred = out.column("prediction")
    check(pred.shape == (n,) and int(pred.min()) >= 0 and int(pred.max()) < E2E_CENTRES,
          "KMeans predictions out of range")
    check(np.isfinite(kmm.cluster_centers_).all() and np.isfinite(kmm.trainingCost),
          "KMeans centres or cost not finite")
    emit({"phase": "e2e", "estimator": "KMeans", "k": E2E_CENTRES, "maxIter": 10, "rows": n,
          "fit_s": t_fit, "transform_s": t_tr, "fit_rows_per_s": n / t_fit,
          "transform_rows_per_s": n / t_tr, "n_iter": kmm.numIter, "cost": kmm.trainingCost,
          "lloyd_step_launches": wrappers["lloyd_step"].launches, "fit_report": kmm._fit_report})
    km_fit_s = t_fit

    lr = LogisticRegression(maxIter=20)
    lrm, t_fit = _timed(torch, lambda: lr.fit(df))
    out, t_tr = _timed(torch, lambda: lrm.transform(df))
    prob = out.column("probability")
    acc = float((out.column("prediction") == y_host).mean())
    check(np.isfinite(prob).all() and np.isfinite(lrm.coefficients).all(), "LogReg not finite")
    check(acc > 0.95, f"LogReg accuracy {acc} on hyperplane labels <= 0.95")
    emit({"phase": "e2e", "estimator": "LogisticRegression", "maxIter": 20, "rows": n,
          "fit_s": t_fit, "transform_s": t_tr, "fit_rows_per_s": n / t_fit,
          "transform_rows_per_s": n / t_tr, "n_iter": lrm.n_iter_, "accuracy": acc,
          "logreg_loss_grad_launches": wrappers["logreg_loss_grad"].launches})

    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # the seeds' cost: maxIter=0 runs the same seeding, then the cost pass
    # (its fit time is the copy + seeding + one cost pass: the Lloyd-free part)
    km0, t_seed = _timed(torch, lambda: KMeans(k=E2E_CENTRES, maxIter=0, seed=seed).fit(df))
    check(kmm.trainingCost <= km0.trainingCost * (1 + 1e-6),
          f"KMeans cost {kmm.trainingCost} above its seeds' {km0.trainingCost}")
    emit({"phase": "e2e", "check": "kmeans_cost_vs_seeds", "cost": kmm.trainingCost,
          "seed_cost": km0.trainingCost, "maxIter0_fit_s": t_seed, "maxIter0_fit_report": km0._fit_report})
    return launches, (kmm, km_fit_s)


def phase_subset(torch, X_host, y_host, seed, rows):
    """The same fits on the card and on the CPU (plain path) on a subset."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    fits = {}
    for dev in ("cuda:0", "cpu"):
        fits[dev] = (
            PCA(k=16, device=dev).fit(df),
            KMeans(k=E2E_CENTRES, maxIter=10, seed=seed, device=dev).fit(df),
            LogisticRegression(maxIter=20, device=dev).fit(df),
        )
    (pg, kg, lg), (pc, kc, lc) = fits["cuda:0"], fits["cpu"]
    # PCA: separated spectrum, f32 sums in other orders
    evr_err = float(np.abs(pg.explained_variance_ratio_ - pc.explained_variance_ratio_).max()
                    / np.abs(pc.explained_variance_ratio_).max())
    pc_err = float(np.abs(pg.pc - pc.pc).max())
    # KMeans: the same seed draws the same numbers, but an ulp of distance
    # may flip one draw near its threshold: hold the cost, not the centres
    cost_rel = abs(kg.trainingCost - kc.trainingCost) / kc.trainingCost
    # LogReg: 20 L-BFGS steps in f32 on each side
    coef_err = float(np.abs(lg.coefficients - lc.coefficients).max() / np.abs(lc.coefficients).max())
    agree = float((lg.transform(df).column("prediction") == lc.transform(df).column("prediction")).mean())
    res = {"phase": "subset", "rows": rows, "pca_evr_rel_err": evr_err, "pca_evr_tol": 1e-4,
           "pca_pc_abs_err": pc_err, "pca_pc_tol": 1e-3, "kmeans_cost_rel_err": cost_rel,
           "kmeans_cost_tol": 0.02, "logreg_coef_rel_err": coef_err, "logreg_coef_tol": 0.05,
           "logreg_prediction_agreement": agree, "logreg_agreement_min": 0.995}
    emit(res)
    check(evr_err <= 1e-4 and pc_err <= 1e-3, "PCA card vs CPU beyond tolerance")
    check(cost_rel <= 0.02, "KMeans card vs CPU cost beyond tolerance")
    check(coef_err <= 0.05 and agree >= 0.995, "LogReg card vs CPU beyond tolerance")


def phase_logreg10_subset(torch, X_host, seed, rows):
    """A 10-class LogisticRegression (multinomial: K3's register-row
    multinomial kernel) fitted on the card and on the CPU; labels
    argmax(X W + Gumbel noise) from numpy. Returns the card fit's K3
    launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    rng = np.random.default_rng(seed + 10)
    X = X_host[:rows]
    W = rng.normal(size=(E2E_D, LOGREG_CLASSES)) * 0.2
    y = (X @ W + rng.gumbel(size=(rows, LOGREG_CLASSES))).argmax(axis=1).astype(np.float32)
    df = DataFrame({"features": X, "label": y})
    lk.logreg_loss_grad.launches = 0
    lg, t_card = _timed(torch, lambda: LogisticRegression(maxIter=20, device="cuda:0").fit(df))
    launches = lk.logreg_loss_grad.launches
    t = time.perf_counter()
    lc = LogisticRegression(maxIter=20, device="cpu").fit(df)
    t_cpu = time.perf_counter() - t
    check(lg.coefficientMatrix.shape == (LOGREG_CLASSES, E2E_D) and np.isfinite(lg.coefficientMatrix).all(),
          "10-class LogReg coefficients not finite/shape")
    coef_err = float(np.abs(lg.coefficientMatrix - lc.coefficientMatrix).max()
                     / np.abs(lc.coefficientMatrix).max())
    pg, pc = lg.transform(df).column("prediction"), lc.transform(df).column("prediction")
    agree = float((pg == pc).mean())
    emit({"phase": "subset", "estimator": "LogisticRegression", "classes": LOGREG_CLASSES, "rows": rows,
          "maxIter": 20, "card_fit_s": t_card, "cpu_fit_s": t_cpu, "n_iter_card": lg.n_iter_,
          "n_iter_cpu": lc.n_iter_, "logreg_loss_grad_launches": launches,
          "variant": k3_variant(lk, E2E_D, LOGREG_CLASSES, True),
          "accuracy_card": float((pg == y).mean()), "coef_rel_err": coef_err, "coef_tol": 0.05,
          "prediction_agreement": agree, "agreement_min": LOGREG10_AGREE_MIN})
    check(launches > 0, "the 10-class card fit launched no K3 kernel")
    check(coef_err <= 0.05 and agree >= LOGREG10_AGREE_MIN, "10-class LogReg card vs CPU beyond tolerance")
    return launches


def wide_data(X_host, seed, d=LOGREG_WIDE_D, rows=None, salt=13):
    """The wide fit's rows, a zero-copy (n * 256 // 3,000, 3,000) view of
    the N x 256 host rows (1,024,000 x 3,000 at 12M; the logreg_realsim
    fit's: ``d`` wide, at most ``rows`` rows), and labels from a numpy
    hyperplane, seeded by ``seed`` + ``salt``, through all ``d`` features
    plus logistic noise: y = [2 z + noise > 0], z the standardized
    projection. Also the accuracy of the hyperplane itself on those
    labels."""
    n_w = min(X_host.size // d, rows or X_host.size)
    Xw = X_host.reshape(-1)[:n_w * d].reshape(n_w, d)
    rng = np.random.default_rng(seed + salt)
    z = Xw @ rng.normal(size=d).astype(np.float32)
    z = (z - np.median(z)) / z.std()
    y = (2.0 * z + rng.logistic(size=n_w) > 0).astype(np.float32)
    return Xw, y, float(((z > 0) == (y > 0)).mean())


def phase_logreg_wide(torch, Xw, y, oracle_acc):
    """The reference's LogisticRegression benchmark config
    (BASELINE.md: binomial, maxIter 200, tol 1e-30, regParam 1e-5) on the
    wide rows through ``DataFrame``: fit then transform on the card. K3
    runs its tile kernel. Returns its launches in the fit, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": Xw, "label": y})
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lrm, t_fit = _timed(torch, lambda: LogisticRegression(maxIter=200, tol=1e-30, regParam=1e-5).fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    out, t_tr = _timed(torch, lambda: lrm.transform(df))
    acc = float((out.column("prediction") == y).mean())
    n = Xw.shape[0]
    emit({"phase": "e2e", "estimator": "LogisticRegression", "path": "logreg_wide", "rows": n,
          "d": Xw.shape[1], "maxIter": 200, "tol": 1e-30, "regParam": 1e-5, "fit_s": t_fit,
          "transform_s": t_tr, "fit_rows_per_s": n / t_fit, "n_iter": lrm.n_iter_, "accuracy": acc,
          "hyperplane_accuracy": oracle_acc, "variant": k3_variant(lk, Xw.shape[1], 1, False),
          "logreg_loss_grad_launches": launches, "launches_by_variant": variants})
    check(np.isfinite(lrm.coefficients).all() and np.isfinite(out.column("probability")).all(),
          "wide LogReg not finite")
    check(launches > 0 and all(1000 <= v < 3000 for v in variants), f"the wide fit's K3 launches {variants} "
          "did not all run the tile kernel")
    check(acc >= oracle_acc - 0.02, f"wide LogReg accuracy {acc} below its hyperplane's {oracle_acc} - 0.02")
    return launches


def phase_logreg_realsim(torch, Xr, y, oracle_acc, k3_ms=None):
    """The reference benchmark's parameters (binomial, maxIter 200, tol
    1e-30, regParam 1e-5) on the logreg_realsim rows through
    ``DataFrame``: the host->device copy alone, then fit and transform on
    the card. Every K3 launch must run the cluster kernel; coefficients
    and probabilities finite; the accuracy within 0.02 of the hyperplane's.
    The fit's time is split into the copy, K3 (its launches times
    ``k3_ms``, the kernel phase's time at this shape) and the rest.
    Returns its launches in the fit, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": Xr, "label": y})
    n, d = Xr.shape
    placed, t_h2d = _timed(torch, lambda: torch.from_numpy(Xr).to("cuda:0"))
    del placed
    torch.cuda.empty_cache()
    t_stage = staged_copy_s(torch, Xr)
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lrm, t_fit = _timed(torch, lambda: LogisticRegression(maxIter=200, tol=1e-30, regParam=1e-5).fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    out, t_tr = _timed(torch, lambda: lrm.transform(df))
    acc = float((out.column("prediction") == y).mean())
    k3_s = launches * k3_ms / 1e3 if k3_ms is not None else None
    emit({"phase": "e2e", "estimator": "LogisticRegression", "path": "logreg_realsim", "rows": n, "d": d,
          "maxIter": 200, "tol": 1e-30, "regParam": 1e-5, "host_to_device_s": t_h2d,
          "host_to_device_gb_per_s": Xr.nbytes / t_h2d / 1e9, "staged_copy_s": t_stage,
          "staged_gb_per_s": Xr.nbytes / t_stage / 1e9, "copy_share": t_stage / t_fit,
          "fit_s": t_fit, "fit_rows_per_s": n / t_fit,
          "k3_s": k3_s, "rest_s": t_fit - t_stage - k3_s if k3_s is not None else None,
          "transform_s": t_tr, "n_iter": lrm.n_iter_, "accuracy": acc, "hyperplane_accuracy": oracle_acc,
          "variant": k3_variant(lk, d, 1, False), "logreg_loss_grad_launches": launches,
          "launches_by_variant": variants})
    check(np.isfinite(lrm.coefficients).all() and np.isfinite(out.column("probability")).all(),
          "real-sim LogReg not finite")
    check(launches > 0 and all(v >= lk._CLUSTER for v in variants), f"the real-sim fit's K3 launches {variants} "
          "did not all run the cluster kernel")
    check(acc >= oracle_acc - 0.02, f"real-sim LogReg accuracy {acc} below its hyperplane's {oracle_acc} - 0.02")
    return launches


def phase_logreg_wide_subset(torch, Xw, y, rows):
    """The wide fit on its first ``rows`` rows with maxIter=20, on the card
    and on the CPU (plain path), held to the 12M path's tolerances.
    Returns the card fit's K3 launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": Xw[:rows], "label": y[:rows]})
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lg, t_card = _timed(torch, lambda: LogisticRegression(maxIter=20, regParam=1e-5, device="cuda:0").fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    t = time.perf_counter()
    lc = LogisticRegression(maxIter=20, regParam=1e-5, device="cpu").fit(df)
    t_cpu = time.perf_counter() - t
    coef_err = float(np.abs(lg.coefficients - lc.coefficients).max() / np.abs(lc.coefficients).max())
    agree = float((lg.transform(df).column("prediction") == lc.transform(df).column("prediction")).mean())
    emit({"phase": "subset", "estimator": "LogisticRegression", "path": "logreg_wide_card_vs_cpu", "rows": rows,
          "d": Xw.shape[1], "maxIter": 20, "card_fit_s": t_card, "cpu_fit_s": t_cpu, "n_iter_card": lg.n_iter_,
          "n_iter_cpu": lc.n_iter_, "logreg_loss_grad_launches": launches, "launches_by_variant": variants,
          "coef_rel_err": coef_err, "coef_tol": 0.05, "prediction_agreement": agree, "agreement_min": 0.995})
    check(launches > 0 and all(1000 <= v < 3000 for v in variants), f"the wide card fit's K3 launches {variants} "
          "did not all run the tile kernel")
    check(coef_err <= 0.05 and agree >= 0.995, "wide LogReg card vs CPU beyond tolerance")
    return launches


def many_data(torch, X_host, seed):
    """The logreg_many fit's rows, a zero-copy (1,024,000, 1,024) view of
    the N x 256 host rows (fewer rows where N x 256 holds fewer), and
    labels argmax(X W + Gumbel noise) with W (1,024 x 64) and the noise
    drawn by numpy from ``seed`` (the products on the card). Also the
    accuracy of the label map itself, argmax(X W), on those labels."""
    n_m = min(LOGREG_MANY_ROWS, X_host.size // LOGREG_MANY_D)
    Xm = X_host.reshape(-1)[:n_m * LOGREG_MANY_D].reshape(n_m, LOGREG_MANY_D)
    rng = np.random.default_rng(seed + 14)
    W = torch.from_numpy((rng.normal(size=(LOGREG_MANY_D, LOGREG_MANY_CLASSES)) * LOGREG_MANY_W).astype(np.float32))
    W = W.to("cuda:0")
    noise = rng.gumbel(size=(n_m, LOGREG_MANY_CLASSES)).astype(np.float32)
    y = np.empty(n_m, np.float32)
    hits = 0
    for lo in range(0, n_m, 1 << 17):
        z = torch.from_numpy(Xm[lo:lo + (1 << 17)]).to("cuda:0") @ W
        lab = (z + torch.from_numpy(noise[lo:lo + (1 << 17)]).to("cuda:0")).argmax(dim=1)
        hits += int((z.argmax(dim=1) == lab).sum())
        y[lo:lo + lab.shape[0]] = lab.cpu().numpy()
    return Xm, y, hits / n_m


def phase_logreg_many(torch, Xm, y, oracle_acc):
    """LogisticRegression(maxIter=20, regParam=1e-5) with 64 classes on
    the logreg_many rows through ``DataFrame``: fit then transform on the
    card. Every K3 launch must run the route past the tile kernel's cap.
    Returns its launches in the fit, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": Xm, "label": y})
    n = Xm.shape[0]
    placed, t_h2d = _timed(torch, lambda: torch.from_numpy(Xm).to("cuda:0"))
    del placed
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lrm, t_fit = _timed(torch, lambda: LogisticRegression(maxIter=20, regParam=1e-5).fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    out, t_tr = _timed(torch, lambda: lrm.transform(df))
    acc = float((out.column("prediction") == y).mean())
    emit({"phase": "e2e", "estimator": "LogisticRegression", "path": "logreg_many", "rows": n,
          "d": Xm.shape[1], "classes": LOGREG_MANY_CLASSES, "maxIter": 20, "regParam": 1e-5,
          "host_to_device_s": t_h2d, "host_to_device_gb_per_s": Xm.nbytes / t_h2d / 1e9, "fit_s": t_fit,
          "transform_s": t_tr, "fit_rows_per_s": n / t_fit, "n_iter": lrm.n_iter_, "accuracy": acc,
          "label_map_accuracy": oracle_acc, "variant": k3_variant(lk, Xm.shape[1], LOGREG_MANY_CLASSES, True),
          "logreg_loss_grad_launches": launches, "launches_by_variant": variants})
    check(lrm.coefficientMatrix.shape == (LOGREG_MANY_CLASSES, Xm.shape[1])
          and np.isfinite(lrm.coefficientMatrix).all() and np.isfinite(out.column("probability")).all(),
          "64-class LogReg coefficients or probabilities not finite/shape")
    check(launches > 0 and all(3000 <= v < lk._CLUSTER for v in variants), f"the 64-class fit's K3 launches {variants} "
          "did not all run the route")
    check(acc >= oracle_acc - 0.02, f"64-class LogReg accuracy {acc} below its label map's {oracle_acc} - 0.02")
    return launches


def onek_data(torch, X_host, seed):
    """The logreg_1k fit's rows, a zero-copy (1,281,167, 2,048) view of
    the N x 256 host rows (fewer rows where N x 256 holds fewer), and
    labels argmax(X W + Gumbel noise), W (2,048 x 1,000) drawn by numpy
    from ``seed`` + 15, the products and the noise on the card: the noise
    is drawn chunk by chunk from a seeded ``torch.Generator`` (-log of a
    unit exponential), as a numpy draw of its 1.28e9 values would take 5
    GB and tens of seconds. Also the accuracy of the label map itself,
    argmax(X W), on those labels, over all rows and over the transform's."""
    n = min(LOGREG_1K_ROWS, X_host.size // LOGREG_1K_D)
    X1 = X_host.reshape(-1)[:n * LOGREG_1K_D].reshape(n, LOGREG_1K_D)
    rng = np.random.default_rng(seed + 15)
    W = torch.from_numpy((rng.normal(size=(LOGREG_1K_D, LOGREG_1K_CLASSES)) * LOGREG_1K_W).astype(np.float32))
    W = W.to("cuda:0")
    g = torch.Generator(device="cuda:0")
    g.manual_seed(seed + 15)
    y = np.empty(n, np.float32)
    hit = np.empty(n, bool)
    for lo in range(0, n, 1 << 17):
        z = torch.from_numpy(X1[lo:lo + (1 << 17)]).to("cuda:0") @ W
        noise = -torch.log(torch.empty_like(z).exponential_(generator=g))
        lab = (z + noise).argmax(dim=1)
        hit[lo:lo + lab.shape[0]] = (z.argmax(dim=1) == lab).cpu().numpy()
        y[lo:lo + lab.shape[0]] = lab.cpu().numpy()
    return X1, y, (float(hit.mean()), float(hit[:LOGREG_1K_TRANSFORM].mean()))


def phase_logreg_1k(torch, X1, y, oracle):
    """LogisticRegression(maxIter=20, regParam=1e-5) with 1,000 classes on
    the logreg_1k rows through ``DataFrame``: the copy alone, the fit, then
    the transform of its first LOGREG_1K_TRANSFORM rows, on the card.
    Every K3 launch must run the class-tiled instance; coefficients and
    probabilities finite; the accuracy on the transform's rows within 0.02
    of the label map's on them. Returns its launches in the fit, counted
    alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": X1, "label": y})
    n = X1.shape[0]
    placed, t_h2d = _timed(torch, lambda: torch.from_numpy(X1).to("cuda:0"))
    del placed
    torch.cuda.empty_cache()
    t_stage = staged_copy_s(torch, X1)
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lrm, t_fit = _timed(torch, lambda: LogisticRegression(maxIter=20, regParam=1e-5).fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    nt = min(n, LOGREG_1K_TRANSFORM)
    out, t_tr = _timed(torch, lambda: lrm.transform(DataFrame({"features": X1[:nt], "label": y[:nt]})))
    acc = float((out.column("prediction") == y[:nt]).mean())
    emit({"phase": "e2e", "estimator": "LogisticRegression", "path": "logreg_1k", "rows": n,
          "d": X1.shape[1], "classes": LOGREG_1K_CLASSES, "maxIter": 20, "regParam": 1e-5,
          "host_to_device_s": t_h2d, "host_to_device_gb_per_s": X1.nbytes / t_h2d / 1e9,
          "staged_copy_s": t_stage, "staged_gb_per_s": X1.nbytes / t_stage / 1e9, "copy_share": t_stage / t_fit,
          "fit_s": t_fit,
          "fit_rows_per_s": n / t_fit, "n_iter": lrm.n_iter_, "transform_rows": nt, "transform_s": t_tr,
          "accuracy_on_transform_rows": acc, "label_map_accuracy": oracle[0],
          "label_map_accuracy_on_transform_rows": oracle[1],
          "variant": k3_variant(lk, X1.shape[1], LOGREG_1K_CLASSES, True),
          "logreg_loss_grad_launches": launches, "launches_by_variant": variants})
    check(lrm.coefficientMatrix.shape == (LOGREG_1K_CLASSES, X1.shape[1])
          and np.isfinite(lrm.coefficientMatrix).all() and np.isfinite(out.column("probability")).all(),
          "1,000-class LogReg coefficients or probabilities not finite/shape")
    check(launches > 0 and set(variants) == {lk._ROUTE_TILED}, f"the 1,000-class fit's K3 launches {variants} "
          "did not all run the class-tiled instance")
    check(acc >= oracle[1] - 0.02, f"1,000-class LogReg accuracy {acc} below its label map's {oracle[1]} - 0.02")
    return launches


def phase_logreg_many_subset(torch, Xm, y, rows, path="logreg_many", classes=LOGREG_MANY_CLASSES,
                             codes=None, reg=1e-5, hold_coef=True, kernel="the route"):
    """The ``path`` fit (logreg_many, or logreg_1k or logreg_realsim with
    its ``classes``, 2 for the binomial form) on its first ``rows`` rows
    with maxIter=20 and regParam ``reg``, on the card (``kernel``: every
    K3 launch one of ``codes``, any route code where None) and on the CPU
    (plain path), each timed. Held to
    MANY_AGREE_MIN and, where ``hold_coef``, to MANY_COEF_TOL (else the
    coefficients' distance is reported only). The disagreements are
    counted, with the share of them whose CPU model's top two logits lie
    within MANY_NEAR_TIE of each other. Returns the card fit's K3
    launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    df = DataFrame({"features": Xm[:rows], "label": y[:rows]})
    lk.logreg_loss_grad.launches, lk.logreg_loss_grad.variants = 0, {}
    lg, t_card = _timed(torch, lambda: LogisticRegression(maxIter=20, regParam=reg, device="cuda:0").fit(df))
    launches, variants = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    t = time.perf_counter()
    lc = LogisticRegression(maxIter=20, regParam=reg, device="cpu").fit(df)
    t_cpu = time.perf_counter() - t
    scale = np.abs(lc.coefficientMatrix).max()
    coef_err = float(np.abs(lg.coefficientMatrix - lc.coefficientMatrix).max() / scale)
    og, oc = lg.transform(df), lc.transform(df)
    dis = og.column("prediction") != oc.column("prediction")
    top2 = np.sort(oc.column("rawPrediction"), axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= MANY_NEAR_TIE
    agree = 1.0 - float(dis.mean())
    emit({"phase": "subset", "estimator": "LogisticRegression", "path": f"{path}_card_vs_cpu", "rows": rows,
          "d": Xm.shape[1], "classes": classes, "maxIter": 20, "regParam": reg, "card_fit_s": t_card,
          "cpu_fit_s": t_cpu, "n_iter_card": lg.n_iter_, "n_iter_cpu": lc.n_iter_,
          "logreg_loss_grad_launches": launches, "launches_by_variant": variants, "coef_rel_err": coef_err,
          "coef_tol": MANY_COEF_TOL, "prediction_agreement": agree, "agreement_min": MANY_AGREE_MIN,
          "disagreements": int(dis.sum()), "near_tie_band": MANY_NEAR_TIE,
          "disagreements_near_tie_share": float(near[dis].mean()) if dis.any() else None,
          "coef_held": hold_coef})
    check(launches > 0 and all(3000 <= v < lk._CLUSTER if codes is None else v in codes for v in variants),
          f"the {classes}-class card fit's K3 launches {variants} did not all run {kernel}")
    check((coef_err <= MANY_COEF_TOL or not hold_coef) and agree >= MANY_AGREE_MIN,
          f"{classes}-class LogReg card vs CPU beyond tolerance (regParam {reg})")
    return launches


# ---------------------------------------------------------------------------
# LinearRegression: the reference's three configs (BASELINE.md:25)
# ---------------------------------------------------------------------------

LINREG_CONFIGS = (("ols", {}), ("elastic_net", {"regParam": 1e-5, "elasticNetParam": 0.5}),
                  ("ridge", {"regParam": 1e-5}))
LINREG_WIDE_D = 3000
# the OLS fit's training RMSE within this share of the noise's σ
LINREG_RMSE_TOL = 0.01
LINREG_WIDE_SUBSET = 20_000
# card vs CPU: coefficients ‖D(β_card - β_cpu)‖ / ‖Dβ_cpu‖ (D the columns'
# std) and the intercept over the terms that make it, |b| + Σ|μᵢβᵢ|: two
# f32 fits of one well-posed system, far inside this
LINREG_CPU_TOL = 1e-3
# the CPU fits at rows × 256 beside the three configs
LINREG_CPU_EXTRA = (("weighted", {"weightCol": "w"}), ("no_intercept", {"fitIntercept": False}),
                    ("unstandardized", {"regParam": 1e-5, "elasticNetParam": 0.5, "standardization": False}))


def linreg_labels(torch, X, seed):
    """y = X·β* + b* + ε for the card's rows ``X`` (n × d): β* ~ N(0, 1/d),
    b* ~ N(0, 1), ε ~ N(0, σ²) with σ = 0.5·std(X·β*), drawn by numpy from
    ``seed`` (the product on the card). Returns (y as host f32, σ)."""
    n, d = X.shape
    rng = np.random.default_rng(seed)
    beta = rng.normal(size=d) / np.sqrt(d)
    b = rng.normal()
    z = (X @ torch.from_numpy(beta.astype(np.float32)).to(X.device)).cpu().numpy().astype(np.float64)
    sigma = 0.5 * float(z.std())
    return (z + b + rng.normal(scale=sigma, size=n)).astype(np.float32), sigma


def ols_reference(torch, X, y, u=U32):
    """OLS on the card's rows ``X`` in f64, in row chunks: the exact means,
    the centred Gram G and Xᵀy, solved as the port's ``solve_normal``
    solves (standardized, with its jitter eps(f32)·trace(A)·I), and the
    tolerance a f32 fit must meet.

    The tolerance is first-order perturbation theory in the standardized
    system A β_s = b (A = D⁻¹GD⁻¹/n, D the columns' std, β_s = Dβ):
    ‖δβ_s‖/‖β_s‖ ≤ κ(A)·(ε_A + ε_b)/(1 - κ(A)·ε_A), with ε_A the norm of
    K1's entry band ``held`` allows on G, u(8·T + 4√n·|G|) with T =
    |Xc|ᵀ|Xc|, plus the Cholesky solve's backward error γ(3d+1)·‖|L||L|ᵀ‖,
    each over ‖A‖; and ε_b the same band on Xy (T = |Xc|ᵀ|yc|) over ‖b‖.
    The intercept's follows: |δb₀| ≤ ‖D⁻¹μ‖·‖Dδβ‖ plus the means' band.
    ``u``: the unit roundoff of the fit held (2⁻⁵³ for a float64 fit,
    whose solve's jitter is then eps(f64)·trace(A)·I)."""
    n, d = X.shape
    f64 = torch.float64
    dev = X.device
    yd = torch.from_numpy(y).to(dev, f64)
    step = max(1, REF_CHUNK * E2E_D // d)
    sx = torch.zeros(d, dtype=f64, device=dev)
    for lo in range(0, n, step):
        sx += X[lo:lo + step].to(f64).sum(dim=0)
    mx, my = sx / n, yd.mean()
    G = torch.zeros((d, d), dtype=f64, device=dev)
    TG = torch.zeros_like(G)
    Xy = torch.zeros(d, dtype=f64, device=dev)
    Ty = torch.zeros_like(Xy)
    for lo in range(0, n, step):
        xc = X[lo:lo + step].to(f64) - mx
        yc = yd[lo:lo + step] - my
        a = xc.abs()
        G += xc.T @ xc
        TG += a.T @ a
        Xy += xc.T @ yc
        Ty += a.T @ yc.abs()
        del xc, a
    return ols_solve_reference(torch, n, G, TG, Xy, Ty, mx, my, u=u)


def ols_solve_reference(torch, n, G, TG, Xy, Ty, mx, my, terms=TOL_TERMS, walk=None, u=U32):
    """``ols_reference``'s solve and tolerance from its f64 sums over n
    rows: the centred G and Xᵀy, and T = |Xc|ᵀ|Xc|, |Xc|ᵀ|yc|; the band
    u·(terms·T + walk·|G|), ``walk`` TOL_WALK·√n unless given, the jitter
    the fit's own eps = 2u."""
    d, f64, dev = G.shape[0], G.dtype, G.device
    walk = TOL_WALK * n ** 0.5 if walk is None else walk
    std = torch.sqrt(torch.diagonal(G) / n)
    A = G / n / torch.outer(std, std)
    b = Xy / n / std
    eye = torch.eye(d, dtype=f64, device=dev)
    A = A + 2.0 * u * torch.trace(A) * eye
    L = torch.linalg.cholesky(A)
    beta_s = torch.cholesky_solve(b[:, None], L)[:, 0]
    ev = torch.linalg.eigvalsh(A)
    kappa = float(ev[-1] / ev[0])
    band_G = u * (terms * TG + walk * G.abs()) / n / torch.outer(std, std)
    band_b = u * (terms * Ty + walk * Xy.abs()) / n / std
    g = (3 * d + 1) * u
    LL = L.abs() @ L.abs().T  # symmetric, so its 2-norm is its top eigenvalue
    eps_gram = float(torch.linalg.matrix_norm(band_G) / ev[-1])
    eps_chol = g / (1 - g) * float(torch.linalg.eigvalsh(LL)[-1] / ev[-1])
    eps_b = float(torch.linalg.vector_norm(band_b) / torch.linalg.vector_norm(b))
    eps_A = eps_gram + eps_chol
    check(kappa * eps_A < 1.0, f"OLS reference: κ·ε_A = {kappa * eps_A:.3g}, no first-order bound")
    tol = kappa * (eps_A + eps_b) / (1.0 - kappa * eps_A)
    beta = beta_s / std
    b0 = my - mx @ beta
    mu_terms = float(my.abs() + (mx.abs() @ beta.abs()))
    tol_b = (float(torch.linalg.vector_norm(mx / std)) * tol * float(torch.linalg.vector_norm(beta_s))
             + u * (terms + walk) * mu_terms)
    host = lambda t: t.cpu().numpy()
    return {"beta": host(beta), "intercept": float(b0), "std": host(std), "kappa": kappa, "eps_gram": eps_gram,
            "eps_chol": eps_chol, "eps_b": eps_b, "coef_tol": tol, "intercept_tol": tol_b}


def linreg_data(torch, X, seed, paths=("linreg", "linreg_wide")):
    """The linreg paths' labels and f64 OLS references, from the card's
    rows ``X`` (n × 256): ``linreg`` on all of them, ``linreg_wide`` on the
    zero-copy (n·256 // 3,000, 3,000) view (1,024,000 × 3,000 at 12M rows,
    the reference's width; the host rows are the same view); those of
    ``paths``."""
    n = X.shape[0]
    n_w = n * E2E_D // LINREG_WIDE_D
    out = {}
    for path, Xp, salt in (("linreg", X, 20), ("linreg_wide", X.reshape(-1)[:n_w * LINREG_WIDE_D].view(
            n_w, LINREG_WIDE_D), 21)):
        if path not in paths:
            continue
        y, sigma = linreg_labels(torch, Xp, seed + salt)
        ref, t_ref = _timed(torch, lambda: ols_reference(torch, Xp, y))
        out[path] = {"y": y, "sigma": sigma, "ref": ref}
        emit({"phase": "e2e", "check": "ols_f64_reference", "path": path, "rows": Xp.shape[0], "d": Xp.shape[1],
              "sigma": sigma, "s": t_ref, **{k: v for k, v in ref.items() if k not in ("beta", "std")}})
        torch.cuda.empty_cache()
    return out


def scaled_errors(m, beta, intercept, std, mx):
    """(‖D(β_m - β)‖ / ‖Dβ‖, |b_m - b| / (|b| + Σ|μᵢβᵢ|)) of model ``m``."""
    coef = np.asarray(m.coefficients, np.float64)
    err = float(np.linalg.norm(std * (coef - beta)) / np.linalg.norm(std * beta))
    err_b = abs(float(m.intercept) - intercept) / (abs(intercept) + float(np.abs(mx) @ np.abs(beta)))
    return err, err_b


def phase_linreg(torch, Xp, data, path):
    """The reference's three LinearRegression configs (BASELINE.md:25) on
    ``Xp`` through ``DataFrame``: fit, transform and the port's
    RegressionEvaluator (rmse) on the card, one K1 launch a fit; OLS held to
    σ and to the f64 reference (``ols_reference``); then ``fitMultiple`` of
    the three: one K1 launch, one copy, models equal bit for bit to the
    separate fits'. Returns the path's K1 launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame, core
    from spark_rapids_ml_tpu_torch.evaluation import RegressionEvaluator
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    y, sigma, ref = data["y"], data["sigma"], data["ref"]
    n, d = Xp.shape
    df = DataFrame({"features": Xp, "label": y})
    t_stage = staged_copy_s(torch, Xp)
    lin.shifted_gram.launches = 0
    fits = {}
    for name, kw in LINREG_CONFIGS:
        k0 = lin.shifted_gram.launches
        m, t_fit = _timed(torch, lambda: LinearRegression(**kw).fit(df))
        launches = lin.shifted_gram.launches - k0
        row = {"phase": "e2e", "estimator": "LinearRegression", "path": path, "config": name, **kw, "rows": n,
               "d": d, "fit_s": t_fit, "fit_rows_per_s": n / t_fit, "n_iter": m._model_attributes["n_iter"],
               "fit_report": m._fit_report, "shifted_gram_launches": launches,
               "staged_copy_s": t_stage, "copy_share": t_stage / t_fit}
        check(np.isfinite(m.coefficients).all() and np.isfinite(m.intercept), f"{path} {name}: not finite")
        out, t_tr = _timed(torch, lambda: m.transform(df))
        pred = out.column("prediction")
        check(pred.shape == (n,) and np.isfinite(pred).all(), f"{path} {name}: predictions not finite/shape")
        rmse = RegressionEvaluator(metricName="rmse").evaluate(out)
        row.update(transform_s=t_tr, transform_rows_per_s=n / t_tr, rmse=rmse, rmse_over_sigma=rmse / sigma)
        del out, pred
        emit(row)
        check(launches == 1, f"{path} {name}: {launches} K1 launches in one fit, not 1")
        fits[name] = (m, row)
    ols, row = fits["ols"]
    dev_s = ref["std"] * (np.asarray(ols.coefficients, np.float64) - ref["beta"])
    err = float(np.linalg.norm(dev_s) / np.linalg.norm(ref["std"] * ref["beta"]))
    err_b = abs(float(ols.intercept) - ref["intercept"])
    emit({"phase": "e2e", "check": "ols_vs_f64", "path": path, "coef_scaled_rel_err": err,
          "coef_tol": ref["coef_tol"], "intercept_abs_err": err_b, "intercept_tol": ref["intercept_tol"],
          "kappa": ref["kappa"], "rmse_over_sigma": row["rmse_over_sigma"], "rmse_tol": LINREG_RMSE_TOL})
    check(abs(row["rmse_over_sigma"] - 1.0) <= LINREG_RMSE_TOL,
          f"{path}: OLS rmse {row['rmse']} not within {LINREG_RMSE_TOL} of σ {sigma}")
    check(err <= ref["coef_tol"] and err_b <= ref["intercept_tol"],
          f"{path}: OLS coefficients {err:.3g} (tol {ref['coef_tol']:.3g}) or intercept {err_b:.3g} "
          f"(tol {ref['intercept_tol']:.3g}) off the f64 solve")

    copies = [0]
    shard_rows = core.shard_rows

    def counted(*a, **k):
        copies[0] += 1
        return shard_rows(*a, **k)

    core.shard_rows = counted
    try:
        k0 = lin.shifted_gram.launches
        multi, t_fm = _timed(torch, lambda: dict(LinearRegression().fitMultiple(df, [kw for _, kw in LINREG_CONFIGS])))
        launches = lin.shifted_gram.launches - k0
    finally:
        core.shard_rows = shard_rows
    diffs = {name: {"coef_max_abs_diff": float(np.abs(multi[i].coefficients - fits[name][0].coefficients).max()),
                    "intercept_abs_diff": abs(float(multi[i].intercept) - float(fits[name][0].intercept)),
                    "n_iter": multi[i]._model_attributes["n_iter"]}
             for i, (name, _) in enumerate(LINREG_CONFIGS)}
    emit({"phase": "e2e", "estimator": "LinearRegression", "path": path, "check": "fitMultiple", "rows": n, "d": d,
          "fit_s": t_fm, "fit_rows_per_s": n / t_fm, "shifted_gram_launches": launches, "copies": copies[0],
          "vs_separate_fits": diffs, "fit_reports": [multi[i]._fit_report for i in range(len(LINREG_CONFIGS))]})
    check(launches == 1 and copies[0] == 1, f"{path}: fitMultiple made {launches} K1 launches and {copies[0]} "
          "copies, not 1 and 1")
    check(all(v["coef_max_abs_diff"] == 0.0 and v["intercept_abs_diff"] == 0.0 for v in diffs.values()),
          f"{path}: fitMultiple's models differ from the separate fits': {diffs}")
    return lin.shifted_gram.launches


def phase_linreg_card_vs_cpu(torch, X_host, y, Xw, yw, rows, seed):
    """LinearRegression fitted on the card and on the CPU (K1's plain
    version): the three configs, a weightCol fit (weights uniform in
    [0.1, 2]), fitIntercept=False and an unstandardized elastic net at
    ``rows`` × 256; OLS and the elastic net at 20,000 × 3,000. Holds
    coefficients and intercepts within LINREG_CPU_TOL and n_iter within 1.
    Returns the card fits' K1 launches, counted alone."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    w = np.random.default_rng(seed + 22).uniform(0.1, 2.0, size=rows).astype(np.float32)
    rw = min(LINREG_WIDE_SUBSET, Xw.shape[0])
    sets = [(X_host[:rows], y[:rows], LINREG_CONFIGS + LINREG_CPU_EXTRA),
            (Xw[:rw], yw[:rw], LINREG_CONFIGS[:2])]
    lin.shifted_gram.launches = 0
    for X, yl, cases in sets:
        n, d = X.shape
        df = DataFrame({"features": X, "label": yl, **({"w": w} if d == E2E_D else {})})
        std = X.astype(np.float64).std(axis=0)
        mx = X.astype(np.float64).mean(axis=0)
        for name, kw in cases:
            g, t_card = _timed(torch, lambda: LinearRegression(device="cuda:0", **kw).fit(df))
            t = time.perf_counter()
            c = LinearRegression(device="cpu", **kw).fit(df)
            t_cpu = time.perf_counter() - t
            err, err_b = scaled_errors(g, np.asarray(c.coefficients, np.float64), float(c.intercept), std, mx)
            it_g, it_c = g._model_attributes["n_iter"], c._model_attributes["n_iter"]
            row = {"phase": "subset", "estimator": "LinearRegression", "path": "linreg_card_vs_cpu", "rows": n,
                   "d": d, "config": name, **kw, "card_fit_s": t_card, "cpu_fit_s": t_cpu, "n_iter_card": it_g,
                   "n_iter_cpu": it_c, "coef_scaled_rel_err": err, "intercept_rel_err": err_b,
                   "tol": LINREG_CPU_TOL}
            if it_g != it_c:
                row["n_iter_reason"] = ("FISTA's stop test max|Δβ| > tol crossed on a different step: the two f32 "
                                        "Grams differ in summation order")
            emit(row)
            check(err <= LINREG_CPU_TOL and err_b <= LINREG_CPU_TOL and abs(it_g - it_c) <= 1,
                  f"LinearRegression {name} at {n} x {d}: card vs CPU beyond tolerance")
    return lin.shifted_gram.launches


def linreg_paths(torch, X_host, data, subset, seed) -> dict:
    """The three LinearRegression paths on the host rows (``data`` from
    ``linreg_data``): their K1 launches, each path counted alone."""
    n_w = X_host.shape[0] * E2E_D // LINREG_WIDE_D
    Xw = X_host.reshape(-1)[:n_w * LINREG_WIDE_D].reshape(n_w, LINREG_WIDE_D)
    return {"linreg": phase_linreg(torch, X_host, data["linreg"], "linreg"),
            "linreg_wide": phase_linreg(torch, Xw, data["linreg_wide"], "linreg_wide"),
            "linreg_card_vs_cpu": phase_linreg_card_vs_cpu(
                torch, X_host, data["linreg"]["y"], Xw, data["linreg_wide"]["y"], min(subset, X_host.shape[0]),
                seed)}


def linreg_probe(torch, args, dev) -> int:
    """K1 at LinearRegression's shapes, then the three LinearRegression
    paths, on ``--rows`` rows made from ``--seed``."""
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import linalg as lin

    t0 = time.perf_counter()
    n = args.rows
    csize = PCA._equal_chunk_rows(n, 1, 65_536)
    X, _ = make_data(torch, n, -(-n // csize) * csize, args.seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 1)
    phase_gram_shapes(torch, lin, X, n, args.reps, g)
    data = linreg_data(torch, X[:n], args.seed)
    X_host = X[:n].cpu().numpy()
    del X
    torch.cuda.empty_cache()
    launches = linreg_paths(torch, X_host, data, args.subset, args.seed)
    emit({"phase": "done", "total_s": time.perf_counter() - t0, "shifted_gram_launches_by_path": launches})
    return 0


# ---------------------------------------------------------------------------
# the streamed out-of-core path: pinned staging, streamed fits, 100M rows
# ---------------------------------------------------------------------------

# chunk rows of the streamed fits: 128 MiB of f32 rows at d = 256
STREAM_CHUNK_ROWS = 131_072
# the north star (BASELINE.md:46-49): 100M x 256 f32, 102.4 GB, more than
# the card's 80 GB; made from a pool of this many chunk-sized host blocks
STREAM_ROWS = 100_000_000
STREAM_POOL_BLOCKS = 8
STREAM_K = 16
# device memory a streamed fit of any row count may hold at once: a few
# chunks in flight, K1's partials and the d x d state
STREAM_PEAK_MAX = 4 << 30
# timed calls of K1 at the chunk shape (about half a millisecond a call)
STREAM_K1_REPS = 20
# the parquet scan: rows of the 12M set written in files of these rows
# (2,000,000 cut to 1,000,000 when the tuning phase (r) joined the run)
PARQUET_ROWS = 1_000_000
PARQUET_FILE_ROWS = 250_000


def rss_bytes() -> int:
    """This process's resident set size (``/proc/self/status``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def f64_sums(torch, blocks, y_blocks=None):
    """Exact (f64) sums over weighted row blocks ``[(X_b, c_b)]`` on the
    card (each block's rows counted c_b times), in two passes: n, the
    means, Σ|x|, the centred Gram G and T = |Xc|ᵀ|Xc|, and with labels
    ``[(y_b, c_b)]`` the centred Xᵀy and |Xc|ᵀ|yc|."""
    f64 = torch.float64
    d, dev = blocks[0][0].shape[1], blocks[0][0].device
    n = sum(c * X.shape[0] for X, c in blocks)
    sx = sum(c * X.to(f64).sum(dim=0) for X, c in blocks)
    sabs = sum(c * X.to(f64).abs().sum(dim=0) for X, c in blocks)
    mx = sx / n
    my = (sum(c * y.to(f64).sum() for y, c in y_blocks) / n) if y_blocks else None
    out = {"n": n, "mx": mx, "my": my, "abs_mean": sabs / n,
           "G": torch.zeros((d, d), dtype=f64, device=dev), "TG": torch.zeros((d, d), dtype=f64, device=dev)}
    if y_blocks:
        out["Xy"] = torch.zeros(d, dtype=f64, device=dev)
        out["Ty"] = torch.zeros(d, dtype=f64, device=dev)
    for i, (X, c) in enumerate(blocks):
        xc = X.to(f64) - mx
        a = xc.abs()
        out["G"] += c * (xc.T @ xc)
        out["TG"] += c * (a.T @ a)
        if y_blocks:
            yc = y_blocks[i][0].to(f64) - my
            out["Xy"] += c * (xc.T @ yc)
            out["Ty"] += c * (a.T @ yc.abs())
        del xc, a
    return out


def pca_truth(torch, sums, k, terms, walk, u=U32):
    """The f64 PCA of ``f64_sums`` and the bands a f32 fit must meet.

    A covariance entry of the fit is within u·(terms·T + walk·|G|)/(n-1)
    of the f64 one (``held``'s band: ``terms`` for the rounding of each
    term and of sums that cancel, ``walk`` for the drift over the
    additions); its Frobenius norm E bounds the error's 2-norm. The f32
    eigensolve adds a backward error of at most d·u·‖C‖. So each
    eigenvalue is within E + d·u·‖C‖ (Weyl), and the sine of the largest
    angle between the fitted and the true top-k subspace within (E +
    d·u·‖C‖)/(λ_k - λ_(k+1)) (Davis-Kahan). The mean is within
    u·(terms + walk)·mean|x| a column. ``u``: the fit's unit roundoff
    (2⁻⁵³ for a float64 fit)."""
    n, G = sums["n"], sums["G"]
    d = G.shape[0]
    C = G / (n - 1)
    evals, evecs = torch.linalg.eigh(C)
    evals, evecs = evals.flip(0), evecs.flip(1)
    band = u * (terms * sums["TG"] + walk * G.abs()) / (n - 1)
    E = float(torch.linalg.matrix_norm(band)) + d * u * float(evals[0])
    gap = float(evals[k - 1] - evals[k])
    return {"n": n, "mean": sums["mx"].cpu().numpy(), "ev": evals[:k].cpu().numpy(), "V": evecs[:, :k],
            "ev_tol": E, "gap": gap, "sin_tol": E / gap, "lambda_1": float(evals[0]),
            "mean_tol": (u * (terms + walk) * sums["abs_mean"]).cpu().numpy()}


def pca_errors(torch, model, truth):
    """(max |λ - λ*|, sin of the largest subspace angle, max |mean - μ*|
    over its band) of a fitted PCAModel against ``pca_truth``."""
    V = truth["V"]
    Vh = torch.from_numpy(np.asarray(model.components_, np.float64)).to(V.device).T
    resid = Vh - V @ (V.T @ Vh)
    sin = float(torch.linalg.matrix_norm(resid, ord=2))
    ev_err = float(np.abs(np.asarray(model.explained_variance_, np.float64) - truth["ev"]).max())
    mean_ratio = float((np.abs(np.asarray(model.mean_, np.float64) - truth["mean"]) / truth["mean_tol"]).max())
    return ev_err, sin, mean_ratio


def check_pca_fit(torch, model, truth, what, tol_scale=1.0):
    ev_err, sin, mean_ratio = pca_errors(torch, model, truth)
    row = {"ev_max_abs_err": ev_err, "ev_tol": tol_scale * truth["ev_tol"], "subspace_sin": sin,
           "sin_tol": tol_scale * truth["sin_tol"], "mean_err_over_tol": mean_ratio / tol_scale,
           "gap": truth["gap"], "lambda_1": truth["lambda_1"]}
    check(truth["sin_tol"] < 1.0, f"{what}: the eigengap {truth['gap']:.3g} gives no subspace bound")
    check(ev_err <= row["ev_tol"] and sin <= row["sin_tol"] and mean_ratio <= tol_scale,
          f"{what}: PCA off its f64 truth: {row}")
    return row


def pca_reference(torch, X, k=STREAM_K):
    """``pca_truth`` of the card's rows ``X`` at the resident band."""
    step = REF_CHUNK
    sums = f64_sums(torch, [(X[lo:lo + step], 1) for lo in range(0, X.shape[0], step)])
    return pca_truth(torch, sums, k, TOL_TERMS, TOL_WALK * X.shape[0] ** 0.5)


def ring_state(torch, dev):
    """The staging ring's buffers (each page-locked) and copy stream (not
    the compute stream), and its counters."""
    from spark_rapids_ml_tpu_torch.parallel import mesh

    ring = mesh.pinned_ring(dev)
    pinned = all(b.is_pinned() for b in ring.slots)
    own_stream = ring.stream.cuda_stream != torch.cuda.current_stream(dev).cuda_stream
    check(pinned, "a staging buffer is not page-locked")
    check(own_stream, "the staging ring copies on the compute stream")
    return ring, {"slots": len(ring.slots), "slot_bytes": ring.slot_bytes, "pinned": pinned,
                  "own_copy_stream": own_stream}


def phase_stream_copy(torch, X_host):
    """(a) The 12M x 256 host rows onto the card: a plain pageable
    ``copy_`` (the old path) and ``shard_rows`` through the staging ring,
    in turns (pageable, staged, staged, pageable)."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows

    dev = torch.device("cuda:0")
    nb = X_host.nbytes

    def pageable():
        xd = torch.empty(X_host.shape, dtype=torch.float32, device=dev)
        xd.copy_(torch.from_numpy(X_host))
        return xd

    ring, state = ring_state(torch, dev)
    times = {"pageable": [], "staged": []}
    host_s = wait_s = 0.0
    for kind in ("pageable", "staged", "staged", "pageable"):
        h0, w0, p0 = ring.host_s, ring.wait_s, ring.pieces
        out, t = _timed(torch, pageable if kind == "pageable" else lambda: shard_rows(X_host, dev))
        del out
        torch.cuda.empty_cache()
        times[kind].append(t)
        if kind == "staged":
            check(ring.pieces - p0 == -(-nb // ring.slot_bytes), "shard_rows did not go through the staging ring")
            host_s, wait_s = ring.host_s - h0, ring.wait_s - w0
    row = {"phase": "streamed", "check": "copy", "bytes": nb, **state,
           "pageable_s": times["pageable"], "staged_s": times["staged"],
           "pageable_gb_per_s": [nb / t / 1e9 for t in times["pageable"]],
           "staged_gb_per_s": [nb / t / 1e9 for t in times["staged"]],
           "staged_host_copy_s": host_s, "staged_buffer_wait_s": wait_s}
    emit(row)
    return row


def phase_stream_vs_resident(torch, X_host, lin, pca_ref):
    """(c) streaming=True fits of PCA(k=16) and of LinearRegression's
    ``fitMultiple`` of the reference's three configs over the in-memory
    12M x 256 rows (an ``ArrayChunkSource``), beside the resident fits of
    the same rows. Each is held to its f64 truth (PCA: ``pca_truth``'s
    bands; OLS: ``ols_reference``'s tolerance, which covers any order of
    the sums), and streamed against resident to twice that (both within
    it of the truth). The streamed ``fitMultiple`` must run one moments
    pass and one Gram pass (one K1 launch a chunk of it). Returns the
    streamed fits' K1 launches."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import linalg as lin_ops
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    n = X_host.shape[0]
    n_chunks = -(-n // STREAM_CHUNK_ROWS)
    df = DataFrame({"features": X_host, "label": lin["y"]})
    kw = {"stream_chunk_rows": STREAM_CHUNK_ROWS}
    res_pca, t_res = _timed(torch, lambda: PCA(k=STREAM_K).fit(df))
    k0 = lin_ops.shifted_gram.launches
    str_pca, t_str = _timed(torch, lambda: PCA(k=STREAM_K, streaming=True, **kw).fit(df))
    k_pca = lin_ops.shifted_gram.launches - k0
    rep = str_pca._ingest_report
    rows = {"resident": check_pca_fit(torch, res_pca, pca_ref, "resident PCA"),
            "streamed": check_pca_fit(torch, str_pca, pca_ref, "streamed PCA")}
    vs = check_pca_fit(torch, str_pca, {**pca_ref, "ev": res_pca.explained_variance_.astype(np.float64),
                                        "mean": res_pca.mean_.astype(np.float64),
                                        "V": torch.from_numpy(res_pca.components_.T.astype(np.float64)).to(
                                            pca_ref["V"].device)},
                       "streamed vs resident PCA", tol_scale=2.0)
    emit({"phase": "streamed", "check": "pca_streamed_vs_resident", "rows": n, "k": STREAM_K,
          "resident_fit_s": t_res, "streamed_fit_s": t_str, "streamed_rows_per_s": n / t_str,
          "vs_f64": rows, "streamed_vs_resident": vs, "shifted_gram_launches": k_pca, "ingest": rep})
    check(rep["passes"] == {"moments": 1, "gram": 1} and k_pca == n_chunks,
          f"streamed PCA: passes {rep['passes']}, {k_pca} K1 launches (want {n_chunks})")

    grid = [c for _, c in LINREG_CONFIGS]
    res_lr, t_res = _timed(torch, lambda: dict(LinearRegression().fitMultiple(df, grid)))
    k0 = lin_ops.shifted_gram.launches
    str_lr, t_str = _timed(torch, lambda: dict(LinearRegression(streaming=True, **kw).fitMultiple(df, grid)))
    k_lr = lin_ops.shifted_gram.launches - k0
    ref = lin["ref"]
    mx = X_host[:: max(1, n // 65536)].astype(np.float64).mean(axis=0)
    errs = {}
    for i, (name, _) in enumerate(LINREG_CONFIGS):
        e_ref = scaled_errors(str_lr[i], ref["beta"], ref["intercept"], ref["std"], mx)
        e_res = scaled_errors(str_lr[i], np.asarray(res_lr[i].coefficients, np.float64),
                              float(res_lr[i].intercept), ref["std"], mx)
        errs[name] = {"vs_resident": e_res, "n_iter": [str_lr[i]._model_attributes["n_iter"],
                                                        res_lr[i]._model_attributes["n_iter"]]}
        if name == "ols":
            errs[name]["vs_f64"] = e_ref
            check(e_ref[0] <= ref["coef_tol"], f"streamed OLS {e_ref[0]:.3g} off the f64 solve "
                                               f"(tol {ref['coef_tol']:.3g})")
        check(np.isfinite(str_lr[i].coefficients).all() and e_res[0] <= 2 * ref["coef_tol"],
              f"streamed {name} {e_res[0]:.3g} off the resident fit (tol {2 * ref['coef_tol']:.3g})")
    rep = str_lr[0]._ingest_report
    emit({"phase": "streamed", "check": "linreg_streamed_vs_resident", "rows": n, "resident_fit_multiple_s": t_res,
          "streamed_fit_multiple_s": t_str, "streamed_rows_per_s": n / t_str, "errors": errs,
          "coef_tol": ref["coef_tol"], "shifted_gram_launches": k_lr, "ingest": rep,
          "fit_reports": [str_lr[i]._fit_report for i in range(len(grid))]})
    check(rep["passes"] == {"moments": 1, "gram": 1} and k_lr == n_chunks,
          f"streamed fitMultiple: passes {rep['passes']}, {k_lr} K1 launches (want one Gram pass, {n_chunks})")
    return k_pca + k_lr


def north_star_pool(torch, seed, dev):
    """STREAM_POOL_BLOCKS host blocks of STREAM_CHUNK_ROWS rows x 256 made
    on the card from ``seed``: x = (z·s)Qᵀ + μ with z ~ N(0, I), scales s
    from 3.0 down by 0.1 over the 16 leading directions and 1 past them (an
    eigengap of ~1.2 after the 16th), Q a random rotation, μ ~ N(0, 4);
    labels y = x·β* + b* + ε, ε's σ half of std(x·β*). Returns the blocks
    and labels on the card and on the host."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 30)
    d = E2E_D
    s = torch.ones(d, device=dev)
    s[:STREAM_K] = 3.0 - 0.1 * torch.arange(STREAM_K, device=dev)
    Q, _ = torch.linalg.qr(torch.randn(d, d, generator=g, device=dev, dtype=torch.float64))
    mu = 2.0 * torch.randn(d, generator=g, device=dev)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    b0 = float(torch.randn(1, generator=g, device=dev))
    pool = torch.empty((STREAM_POOL_BLOCKS, STREAM_CHUNK_ROWS, d), dtype=torch.float32, device=dev)
    ys = torch.empty((STREAM_POOL_BLOCKS, STREAM_CHUNK_ROWS), dtype=torch.float32, device=dev)
    for b in range(STREAM_POOL_BLOCKS):
        z = torch.randn(STREAM_CHUNK_ROWS, d, generator=g, device=dev) * s
        pool[b] = z @ Q.T.to(torch.float32) + mu
        ys[b] = pool[b] @ beta
    sigma = 0.5 * float(ys.std())
    ys += b0 + sigma * torch.randn(ys.shape, generator=g, device=dev)
    return pool, ys, pool.cpu().numpy(), ys.cpu().numpy()


def phase_north_star(torch, seed):
    """(d) PCA(k=16) and the three-config LinearRegression ``fitMultiple``
    on 100,000,000 x 256 f32 rows (102.4 GB, more than the card holds),
    from a ``GeneratorChunkSource``, each through its estimator's own
    streaming fit function handed a ``StreamInputs`` (the call
    ``_fit_lanes`` makes). The generator yields views of a pool of host
    blocks, the block of each chunk drawn from ``seed``, so it does not set
    the pace, and the f64 truth of the whole set follows from the blocks'
    f64 sums and their counts. The band is derived from the chunks: each
    chunk's sums within K1's (walk over its rows), then an f32 sum of
    n_chunks chunk partials (n_chunks·u·T more). Peak device memory under
    STREAM_PEAK_MAX; one moments and one Gram pass (n_chunks K1 launches)
    for each fit. K1 is first held and timed at the chunk shape, and held
    on the ragged last chunk. Returns the K1 launches of the fits and K1's
    measurement at the chunk shape."""
    from spark_rapids_ml_tpu_torch.core import StreamInputs
    from spark_rapids_ml_tpu_torch.data.chunks import GeneratorChunkSource
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import linalg as lin_ops
    from spark_rapids_ml_tpu_torch.ops import streaming as st
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    dev = torch.device("cuda:0")
    N, CH = STREAM_ROWS, STREAM_CHUNK_ROWS
    n_chunks = -(-N // CH)
    last = N - (n_chunks - 1) * CH
    (pool, ys, pool_h, ys_h), t_pool = _timed(torch, lambda: north_star_pool(torch, seed, dev))
    order = np.random.default_rng(seed + 31).integers(0, STREAM_POOL_BLOCKS, size=n_chunks)
    counts = np.bincount(order[:-1], minlength=STREAM_POOL_BLOCKS)
    blocks = [(pool[b], int(counts[b])) for b in range(STREAM_POOL_BLOCKS)] + [(pool[order[-1], :last], 1)]
    yb = [(ys[b], int(counts[b])) for b in range(STREAM_POOL_BLOCKS)] + [(ys[order[-1], :last], 1)]
    # K1 as the Gram pass calls it: a full chunk, timed, and the ragged last
    # chunk, its padding rows zero with m = 0, held to the same band
    k1 = check_shifted_gram(torch, lin_ops, pool[0], torch.ones(CH, device=dev), STREAM_K1_REPS, control=True)
    emit({"phase": "kernels", "kernel": "shifted_gram", "shape": "shifted_gram_stream_chunk", **k1})
    ragged = torch.zeros((CH, E2E_D), device=dev)
    ragged[:last] = pool[order[-1], :last]
    m_last = torch.zeros(CH, device=dev)
    m_last[:last] = 1.0
    r = check_shifted_gram(torch, lin_ops, ragged, m_last, 0)
    emit({"phase": "kernels", "kernel": "shifted_gram", "shape": "shifted_gram_stream_last_chunk", **r})
    del ragged, m_last
    sums, t_truth = _timed(torch, lambda: f64_sums(torch, blocks, yb))
    check(sums["n"] == N, "north star: the blocks do not count 100M rows")
    terms, walk = TOL_TERMS + n_chunks, TOL_WALK * CH ** 0.5
    truth = pca_truth(torch, sums, STREAM_K, terms, walk)
    ols = ols_solve_reference_band(torch, sums, terms, walk)
    del pool, ys, blocks, yb
    torch.cuda.empty_cache()

    def gen(start, count, _seed):
        b = order[start // CH]
        return pool_h[b, :count], ys_h[b, :count]

    inputs = StreamInputs(source=GeneratorChunkSource(gen, N, E2E_D, has_label=True), device=dev, n_rows=N,
                          n_features=E2E_D, dtype=torch.float32, chunk_rows=CH)
    emit({"phase": "streamed", "check": "north_star_data", "rows": N, "d": E2E_D, "bytes": N * E2E_D * 4,
          "chunk_rows": CH, "chunks": n_chunks, "last_chunk_rows": last, "pool_blocks": STREAM_POOL_BLOCKS,
          "pool_s": t_pool, "truth_s": t_truth, "eigengap": truth["gap"], "ols_kappa": ols["kappa"]})
    launches = 0
    for what in ("pca", "linreg_fit_multiple"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        st.reset_ingest_report()
        k0 = lin_ops.shifted_gram.launches
        rss0 = rss_bytes()
        t = time.perf_counter()
        if what == "pca":
            est = PCA(k=STREAM_K)
            models = [est._create_model(est._get_streaming_fit_func(None)(inputs, dict(est._tpu_params)))]
        else:
            lr = LinearRegression()
            fit = lr._get_streaming_fit_func(None)
            models = []
            for _, kw in LINREG_CONFIGS:
                est = lr._with_params(kw)
                models.append(est._create_model(fit(inputs, dict(est._tpu_params))))
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev) - base
        k = lin_ops.shifted_gram.launches - k0
        launches += k
        rep = st.last_ingest_report()
        row = {"phase": "streamed", "check": f"north_star_{what}", "rows": N, "fit_s": t_fit,
               "fit_rows_per_s": N / t_fit, "pass_gb_per_s": rep["bytes"] / rep["wall_s"] / 1e9,
               "peak_device_bytes": peak, "peak_max": STREAM_PEAK_MAX, "host_rss_growth_bytes": rss_bytes() - rss0,
               "shifted_gram_launches": k, "ingest": rep}
        if what == "pca":
            row["vs_f64"] = check_pca_fit(torch, models[0], truth, "north-star PCA")
        else:
            row["configs"] = {}
            for (name, _), m in zip(LINREG_CONFIGS, models):
                check(np.isfinite(m.coefficients).all() and np.isfinite(m.intercept), f"north-star {name}: not finite")
                row["configs"][name] = {"n_iter": m._model_attributes["n_iter"], "fit_report": m._fit_report}
            err, err_b = (float(np.linalg.norm(ols["std"] * (np.asarray(models[0].coefficients, np.float64)
                                                             - ols["beta"])) / np.linalg.norm(ols["std"] * ols["beta"])),
                          abs(float(models[0].intercept) - ols["intercept"]))
            row["ols_vs_f64"] = {"coef_scaled_rel_err": err, "coef_tol": ols["coef_tol"], "intercept_abs_err": err_b,
                                 "intercept_tol": ols["intercept_tol"], "kappa": ols["kappa"]}
            check(err <= ols["coef_tol"] and err_b <= ols["intercept_tol"],
                  f"north-star OLS off its f64 truth: {row['ols_vs_f64']}")
        emit(row)
        check(rep["passes"] == {"moments": 1, "gram": 1} and rep["chunks"] == 2 * n_chunks and k == n_chunks,
              f"north-star {what}: passes {rep['passes']}, {rep['chunks']} chunks, {k} K1 launches "
              f"(want one moments and one Gram pass of {n_chunks} chunks)")
        check(peak < STREAM_PEAK_MAX, f"north-star {what}: peak device memory {peak} >= {STREAM_PEAK_MAX}")
    return launches, k1


def ols_solve_reference_band(torch, sums, terms, walk):
    """``ols_solve_reference`` at a band of u·(terms·T + walk·|G|)."""
    return ols_solve_reference(torch, sums["n"], sums["G"], sums["TG"], sums["Xy"], sums["Ty"], sums["mx"],
                               sums["my"], terms=terms, walk=walk)


def phase_stream_parquet(torch, X_host):
    """(e) Where pyarrow imports: the first PARQUET_ROWS of the host rows
    written in files of PARQUET_FILE_ROWS, ``scan_parquet``, a streamed
    PCA(k=16) fit and a streamed transform of the scan; neither may
    materialize it. The fit is held against the in-memory fit of the same
    rows (twice the resident band of ``pca_truth``), the transform against
    the model's transform of the rows in memory. Returns the K1 launches,
    or None when it did not run."""
    import tempfile

    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        emit({"phase": "streamed", "check": "parquet", "ran": False, "reason": f"pyarrow is missing: {e}"})
        return None
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.data.dataframe import AugmentedScanFrame
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import linalg as lin_ops

    X = X_host[:PARQUET_ROWS]
    n = X.shape[0]
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        _, t_write = _timed(torch, lambda: DataFrame({"features": X}).write_parquet(
            tmp, rows_per_file=PARQUET_FILE_ROWS))
        scan = DataFrame.scan_parquet(tmp)
        k0 = lin_ops.shifted_gram.launches
        model, t_fit = _timed(torch, lambda: PCA(k=STREAM_K, stream_chunk_rows=STREAM_CHUNK_ROWS).fit(scan))
        k = lin_ops.shifted_gram.launches - k0
        out, t_tr = _timed(torch, lambda: model.transform(scan))
        materialized = scan.is_materialized() or out.is_materialized()
        proj = out.column("pca_features")
    truth = pca_reference(torch, torch.from_numpy(X).to(dev))
    mem, t_mem = _timed(torch, lambda: PCA(k=STREAM_K).fit(DataFrame({"features": X})))
    vs = check_pca_fit(torch, model, {**truth, "ev": mem.explained_variance_.astype(np.float64),
                                      "mean": mem.mean_.astype(np.float64),
                                      "V": torch.from_numpy(mem.components_.T.astype(np.float64)).to(dev)},
                       "parquet PCA vs the in-memory fit", tol_scale=2.0)
    ref = model.transform(DataFrame({"features": X})).column("pca_features")
    tr_err = float(np.abs(proj - ref).max())
    rep = model._ingest_report
    emit({"phase": "streamed", "check": "parquet", "ran": True, "rows": n, "files": -(-n // PARQUET_FILE_ROWS),
          "write_s": t_write, "fit_s": t_fit, "fit_rows_per_s": n / t_fit, "in_memory_fit_s": t_mem,
          "transform_s": t_tr, "materialized": materialized, "vs_in_memory": vs, "transform_max_abs_err": tr_err,
          "shifted_gram_launches": k, "ingest": rep})
    check(isinstance(out, AugmentedScanFrame) and not materialized, "the parquet scan was materialized")
    check(proj.shape == (n, STREAM_K) and tr_err <= 1e-5 * float(np.abs(ref).max()),
          f"streamed transform of the scan off the in-memory transform: {tr_err}")
    check(rep["passes"] == {"moments": 1, "gram": 1}, f"parquet PCA passes {rep['passes']}")
    return k


# ---------------------------------------------------------------------------
# the streamed LogisticRegression: K3 at the chunk shapes, fits held against
# f64 reference fits, the north star
# ---------------------------------------------------------------------------

# maxIter of the streamed LogisticRegression fits (the bench's 20 cut to 5:
# at 100M every evaluation is a full pass of ~8-12 s; 5 cut to 3 when the
# tuning phase (r) joined the run) and the north star's regParam (the
# reference benchmark's)
STREAM_LR_ITER = 3
STREAM_LR_REG = 1e-5
# the north star's maxIter: 5 cut to 2 when the tuning phase (r) joined the
# run
NORTH_STAR_LR_ITER = 2
# timed calls of K3 at each chunk shape
STREAM_K3_REPS = 10
# the sparse opt-in: LIBSVM real-sim's shape, 72,309 x 20,958 at ~0.25%
# density (its 3.7M nonzeros), made from --seed
SPARSE_ROWS = 72_309
SPARSE_D = 20_958
SPARSE_DENSITY = 0.0025


def sparse_realsim(seed):
    """A CSR matrix of real-sim's shape and density from ``seed``
    (uniform [0, 1) values, as tf-idf weights), and labels
    Bernoulli(σ(2 z)), z the standardized projection on a numpy
    hyperplane."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed + 40)
    Xs = sp.random(SPARSE_ROWS, SPARSE_D, density=SPARSE_DENSITY, format="csr", random_state=rng,
                   dtype=np.float32)
    z = np.asarray(Xs @ rng.normal(size=SPARSE_D).astype(np.float32)).ravel()
    z = (z - z.mean()) / z.std()
    y = (rng.uniform(size=SPARSE_ROWS) < 1.0 / (1.0 + np.exp(-2.0 * z))).astype(np.float32)
    return Xs, y


def dense_rows(rows, a, b):
    """Rows [a, b) of a dense or CSR matrix as a dense f32 array."""
    part = rows[a:b]
    return np.ascontiguousarray(part.toarray() if hasattr(part, "toarray") else part, dtype=np.float32)


def chunk_pair(torch, rows, y, chunk):
    """The first chunk and the zero-padded last chunk a streamed pass
    gives K3 over ``rows`` (dense or CSR, ``y`` its labels), on the card:
    ((X, y, m) of each, the last chunk's real rows)."""
    dev = torch.device("cuda:0")
    n, d = rows.shape
    lo = (-(-n // chunk) - 1) * chunk
    out = []
    for a, b in ((0, chunk), (lo, n)):
        X = torch.zeros((chunk, d), device=dev)
        yy = torch.zeros(chunk, device=dev)
        m = torch.zeros(chunk, device=dev)
        X[:b - a] = torch.from_numpy(dense_rows(rows, a, b)).to(dev)
        yy[:b - a] = torch.from_numpy(y[a:b]).to(dev)
        m[:b - a] = 1.0
        out.append((X, yy, m))
    return out, n - lo


def phase_stream_k3(torch, lk, X_host, y_host, Xm, ym, Xs, ys, seed):
    """(f) K3 at the three shapes a streamed LogisticRegression gives it
    (``auto_chunk_rows``' 128 MB chunks): 131,072 x 256 binomial (the
    row-per-warp kernel), 32,768 x 1,024 with 64 classes (the route),
    1,601 x 20,958 binomial (the cluster kernel), each its first chunk and
    its zero-padded last chunk (rows past the real ones m = 0, y = 0),
    held against the f64 plain version with every control (strict), the
    first timed beside its plain version and one autograd call, with its
    bound. Returns the measurements by kernels-line row name."""
    from spark_rapids_ml_tpu_torch.data.chunks import auto_chunk_rows

    out = {}
    for name, rows, y, K in (("logreg_loss_grad_stream_rows", X_host, y_host, 1),
                             ("logreg_loss_grad_stream_route", Xm, ym, LOGREG_MANY_CLASSES),
                             ("logreg_loss_grad_stream_cluster", Xs, ys, 1)):
        chunk = auto_chunk_rows(rows.shape[1], 4, 1)
        (first, last), n_valid = chunk_pair(torch, rows, y, chunk)
        r = check_logreg(torch, lk, *first, K, STREAM_K3_REPS, seed, control=True, strict=True)
        r_last = check_logreg(torch, lk, *last, K, 0, seed, control=True, strict=True, n_valid=n_valid)
        r["last_chunk"] = {"n_valid": n_valid, **{k: r_last[k] for k in (
            "variant", "max_abs_err", "err_over_tol", "loss_err_over_tol", "gb_err_over_tol")},
            "controls": [(c["control"], c["err_over_tol"]) for c in r_last["controls"]]}
        check(r["variant"] == r_last["variant"], f"{name}: the last chunk ran {r_last['variant']}, "
                                                 f"the first {r['variant']}")
        emit({"phase": "kernels", "kernel": "logreg_loss_grad", "shape": name,
              **{k: v for k, v in r.items() if k != "controls"},
              "controls": [(c["control"], c["err_over_tol"]) for c in r["controls"]]})
        out[name] = r
        del first, last
    torch.cuda.empty_cache()
    return out


def lr_blocks(torch, rows, y, chunk):
    """The streamed chunks of ``rows`` (dense or CSR) and labels ``y`` as
    f64-reference blocks [(X, y, count)] on the card, one a chunk, real
    rows only."""
    dev = torch.device("cuda:0")
    return [(torch.from_numpy(dense_rows(rows, a, a + chunk)).to(dev),
             torch.from_numpy(np.ascontiguousarray(y[a:a + chunk])).to(dev), 1)
            for a in range(0, rows.shape[0], chunk)]


def lr_moments64(torch, blocks):
    """f64 (n, mean, unbiased std) of the blocks' rows, each counted its
    block's count."""
    f64 = torch.float64
    n = sum(c * X.shape[0] for X, _, c in blocks)
    mean = sum(c * X.to(f64).sum(dim=0) for X, _, c in blocks) / n
    ss = sum(c * ((X.to(f64) - mean) ** 2).sum(dim=0) for X, _, c in blocks)
    return float(n), mean, torch.sqrt(ss / max(n - 1.0, 1.0))


class LrTruth:
    """The f64 LogisticRegression objective of weighted row blocks
    [(X, y, count)] (each block one streamed chunk, or one pool block
    counted as often as the chunks it backs), in the solver's standardized
    coordinates at given (mean, inv_std) (standardization and an
    intercept, the estimator's defaults), with the rounding band of the
    port's two ways of computing it: streamed (K3 a chunk of ``chunk``
    rows, then an f32 sum of ``n_chunks`` partials) and resident (one K3
    call over all rows). A chunk's output is within K3's band u·(8·T +
    4·√chunk·|ref|) (``held``; T the sum of its terms' absolute values,
    Σ|r|·|x| for the gradient, not Σ|r|·|x − μ|), the f32 sum of the
    partials adds at most n_chunks·u·T; the chain rule back to the
    standardized coefficients, gA = (gAeff − gbeff ⊗ mean)·inv_std, adds
    the intercept's band times |mean|, since the mean term cancels."""

    def __init__(self, torch, lk, blocks, mean, inv_std, *, K, l2, chunk, n_chunks):
        self.torch, self.lk, self.blocks = torch, lk, blocks
        self.mean, self.inv_std = mean.to(torch.float64), inv_std.to(torch.float64)
        self.K, self.l2 = K, l2
        self.chunk, self.n_chunks = chunk, n_chunks
        self.n = float(sum(c * X.shape[0] for X, _, c in blocks))
        self.d = blocks[0][0].shape[1]
        self.evals = 0

    def effective(self, w):
        torch, K, d = self.torch, self.K, self.d
        w = torch.from_numpy(np.asarray(w, np.float64)).to(self.mean.device)
        Aeff = w[:K * d].reshape(K, d) * self.inv_std[None, :]
        return w, Aeff, w[K * d:] - Aeff @ self.mean

    def sums(self, Aeff, beff):
        """Σ over the blocks of (loss, gA, gb), their T and Σ|ref| a chunk."""
        torch = self.torch
        acc = None
        for X, y, c in self.blocks:
            m = torch.ones(X.shape[0], device=X.device)
            l_, gA, gb, TgA, Tgb, Tl = logreg_reference(torch, self.lk, X, y, m, Aeff, beff, self.K > 1)
            part = {"loss": l_, "gA": gA, "gb": gb, "T_loss": Tl, "T_gA": TgA, "T_gb": Tgb,
                    "a_loss": l_.abs(), "a_gA": gA.abs(), "a_gb": gb.abs()}
            acc = {k: c * v for k, v in part.items()} if acc is None else {k: acc[k] + c * v for k, v in part.items()}
        return acc

    def flat(self, gA, gb):
        return self.torch.cat([((gA - gb[:, None] * self.mean[None, :]) * self.inv_std[None, :]).reshape(-1), gb])

    def band_flat(self, eA, eb):
        return self.torch.cat([((eA + eb[:, None] * self.mean.abs()[None, :]) * self.inv_std[None, :]).reshape(-1),
                               eb])

    def __call__(self, w_np, bands=False):
        """(f, g) at ``w_np`` as the solver sees them (data term / n plus
        the L2 term on the coefficients); with ``bands``, also the streamed
        and the resident bands of f and of each entry of g."""
        self.evals += 1
        w, Aeff, beff = self.effective(w_np)
        s = self.sums(Aeff, beff)
        coefs = w.clone()
        coefs[self.K * self.d:] = 0.0
        f = float(s["loss"]) / self.n + 0.5 * self.l2 * float(coefs @ coefs)
        g = self.flat(s["gA"], s["gb"]) / self.n + self.l2 * coefs
        if not bands:
            return f, g.cpu().numpy()
        out = {}
        for mode, terms, walk, a in (("streamed", TOL_TERMS + self.n_chunks, TOL_WALK * self.chunk ** 0.5, "a_"),
                                     ("resident", TOL_TERMS, TOL_WALK * self.n ** 0.5, "")):
            e = {k: U32 * (terms * s["T_" + k] + walk * (s[a + k] if a else s[k].abs())) for k in ("loss", "gA", "gb")}
            out[mode] = (float(e["loss"]) / self.n, (self.band_flat(e["gA"], e["gb"]) / self.n).cpu().numpy())
        return f, g.cpu().numpy(), out

    def objective_of(self, coef, intercept, std):
        """The f64 objective of a fitted model's (coef (K, d), intercept
        (K,)) in original coordinates, its penalty on coef·std."""
        torch = self.torch
        dev = self.mean.device
        Aeff = torch.from_numpy(np.atleast_2d(np.asarray(coef, np.float64))).to(dev)
        beff = torch.from_numpy(np.atleast_1d(np.asarray(intercept, np.float64))).to(dev)
        s = self.sums(Aeff, beff)
        A = Aeff * std[None, :]
        return float(s["loss"]) / self.n + 0.5 * self.l2 * float((A * A).sum())


@contextlib.contextmanager
def record_streamed_fit(st, lk):
    """While open: every evaluation of a streamed LogisticRegression's
    host solver (w, f, g), the moments it used, and the calls of K3's plain
    version (none may come from the streamed path on the card)."""
    rec = {"evals": [], "moments": None, "plain_calls": 0}
    real_min, real_mom, real_plain = st.minimize_lbfgs_host, st.streamed_logreg_moments, lk.logreg_loss_grad_plain

    def minimize(value_grad, w0, **kw):
        def traced(w):
            f, g = value_grad(w)
            rec["evals"].append((np.array(w), float(f), np.array(g)))
            return f, g
        return real_min(traced, w0, **kw)

    def moments(*a, **kw):
        rec["moments"] = real_mom(*a, **kw)
        return rec["moments"]

    def plain(*a, **kw):
        rec["plain_calls"] += 1
        return real_plain(*a, **kw)

    st.minimize_lbfgs_host, st.streamed_logreg_moments, lk.logreg_loss_grad_plain = minimize, moments, plain
    try:
        yield rec
    finally:
        st.minimize_lbfgs_host, st.streamed_logreg_moments, lk.logreg_loss_grad_plain = real_min, real_mom, real_plain


def lr_reference_fit(torch, blocks, lk, *, K, l2, chunk, n_chunks, max_iter, tol=1e-6):
    """The f64 reference: the port's host solver (``minimize_lbfgs_host``,
    the same algorithm as the streamed fit's) on the f64 objective of the
    blocks at their exact moments, ``max_iter`` iterations. Returns the
    truth, its std, the solver's result, the solution's (coef, intercept)
    and the evaluations it took."""
    from spark_rapids_ml_tpu_torch.ops.lbfgs import minimize_lbfgs_host

    n, mean, std = lr_moments64(torch, blocks)
    inv_std = torch.where(std > 0, 1.0 / std, torch.ones_like(std))
    truth = LrTruth(torch, lk, blocks, mean, inv_std, K=K, l2=l2, chunk=chunk, n_chunks=n_chunks)
    res = minimize_lbfgs_host(truth, np.zeros(K * truth.d + K), max_iter=max_iter, tol=tol)
    _, Aeff, beff = truth.effective(res.w)
    if K > 1:
        beff = beff - beff.mean()
    return truth, std, res, Aeff.cpu().numpy(), beff.cpu().numpy(), truth.evals


def hold_fits(torch, truth, std, ref, ref_coef, ref_b, evals, models, what):
    """Each fitted model's f64 objective against the reference fit's: the
    gap within the evaluation band at the reference's solution (streamed
    or resident, as the model was fitted) compounded over the reference's
    ``evals`` evaluations. Returns the rows of the check."""
    f_ref = truth.objective_of(ref_coef, ref_b, std)
    _, _, bands = truth(ref.w, bands=True)
    rows = {}
    for mode, m in models.items():
        f_m = truth.objective_of(m.coefficientMatrix, m.interceptVector, std)
        tol = evals * bands[mode][0]
        coef_diff = float(np.abs(np.asarray(m.coefficientMatrix, np.float64) - ref_coef).max())
        rows[mode] = {"objective_f64": f_m, "gap": f_m - f_ref, "gap_tol": tol, "n_iter": m.n_iter_,
                      "coef_max_abs_diff_vs_ref": coef_diff,
                      "coef_rel_diff_vs_ref": coef_diff / float(np.abs(ref_coef).max()),
                      "intercept_max_abs_diff_vs_ref": float(np.abs(np.asarray(m.interceptVector, np.float64)
                                                                    - ref_b).max())}
        check(np.isfinite(m.coefficientMatrix).all() and np.isfinite(m.interceptVector).all(),
              f"{what} {mode}: not finite")
        check(abs(f_m - f_ref) <= tol, f"{what} {mode}: f64 objective {f_m!r} off the reference's {f_ref!r} "
                                       f"by more than {tol:.3g}")
    return {"reference_objective_f64": f_ref, "reference_n_iter": ref.n_iter, "reference_evals": evals,
            "fits": rows}


def stream_vs_resident_lr(torch, lk, st, rows, y, *, K, what, kernel, codes, seed, reg=0.0, sparse=None):
    """(g, h, j) LogisticRegression(maxIter=STREAM_LR_ITER) on ``rows`` /
    ``y`` streamed (``streaming=True``; ``sparse``: the CSR matrix with the
    sparse opt-in instead) and resident, the streamed fit's K3 launches
    one a chunk of each objective pass, every one by a kernel of
    ``codes`` and none of K3's plain version; both held against the f64
    reference fit of the same rows (``hold_fits``). Returns (streamed
    launches, resident launches, the streamed model, the resident model)."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.data.chunks import auto_chunk_rows

    n, d = rows.shape
    chunk = auto_chunk_rows(d, 4, 1)
    n_chunks = -(-n // chunk)
    kw = {"maxIter": STREAM_LR_ITER, "regParam": reg}
    df_str = DataFrame({"features": sparse if sparse is not None else rows, "label": y})
    est = LogisticRegression(enable_sparse_data_optim=True, **kw) if sparse is not None else LogisticRegression(
        streaming=True, **kw)
    k0, v0 = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    with record_streamed_fit(st, lk) as rec:
        m_str, t_str = _timed(torch, lambda: est.fit(df_str))
    k_str = lk.logreg_loss_grad.launches - k0
    v_str = {c: v - v0.get(c, 0) for c, v in lk.logreg_loss_grad.variants.items() if v != v0.get(c, 0)}
    rep = m_str._ingest_report
    k0, v0 = lk.logreg_loss_grad.launches, dict(lk.logreg_loss_grad.variants)
    m_res, t_res = _timed(torch, lambda: LogisticRegression(**kw).fit(DataFrame({"features": rows, "label": y})))
    k_res = lk.logreg_loss_grad.launches - k0
    v_res = {c: v - v0.get(c, 0) for c, v in lk.logreg_loss_grad.variants.items() if v != v0.get(c, 0)}
    check(m_res._ingest_report == {}, f"{what}: the resident fit streamed")
    blocks = lr_blocks(torch, rows, y, chunk)
    ref, t_ref = _timed(torch, lambda: lr_reference_fit(
        torch, blocks, lk, K=K, l2=reg, chunk=chunk, n_chunks=n_chunks, max_iter=STREAM_LR_ITER))
    truth = ref[0]
    held_rows = hold_fits(torch, *ref, {"streamed": m_str, "resident": m_res}, what)
    passes = rep["passes"]
    row = {"phase": "streamed", "check": what, "rows": n, "d": d, "classes": K if K > 1 else 2, "chunk_rows": chunk,
           "chunks": n_chunks, "maxIter": STREAM_LR_ITER, "regParam": reg, "streamed_fit_s": t_str,
           "resident_fit_s": t_res, "reference_fit_s": t_ref, "streamed_rows_per_s": n / t_str,
           "passes": passes, "objective_pass_s": rep["pass_s"]["objective"] / passes["objective"],
           "streamed_evals": len(rec["evals"]), "logreg_loss_grad_launches": k_str,
           "launches_by_variant": v_str, "resident_launches": k_res, "resident_launches_by_variant": v_res,
           "plain_calls": rec["plain_calls"], **held_rows, "ingest": rep}
    del blocks, truth
    torch.cuda.empty_cache()
    emit(row)
    check(k_str == n_chunks * passes["objective"] and passes["objective"] == len(rec["evals"]),
          f"{what}: {k_str} K3 launches over {passes['objective']} objective passes of {n_chunks} chunks")
    check(set(v_str) <= codes and set(v_res) <= codes, f"{what}: K3 ran {v_str} / {v_res}, not {kernel}")
    check(rec["plain_calls"] == 0, f"{what}: K3's plain version ran {rec['plain_calls']} times on the card's path")
    check(passes.get("labels") == 1 and passes.get("moments") == 1 and passes.get("variance") == 1,
          f"{what}: passes {passes}")
    return k_str, k_res, m_str, m_res


def north_star_labels(torch, pool, seed):
    """Binomial labels of the pool's rows, Bernoulli(σ(x·β + b)) from
    ``seed``, β scaled so the logits' spread is about 2 (not separable)."""
    g = torch.Generator(device=pool.device)
    g.manual_seed(seed + 32)
    d = pool.shape[2]
    beta = torch.randn(d, generator=g, device=pool.device)
    z = pool @ beta
    z = (z - z.mean()) * (2.0 / float(z.std())) + 0.3
    return (torch.rand(z.shape, generator=g, device=pool.device) < torch.sigmoid(z)).to(torch.float32)


def phase_north_star_logreg(torch, lk, st, seed):
    """(k) LogisticRegression(regParam=STREAM_LR_REG, maxIter=NORTH_STAR_LR_ITER)
    on 100,000,000 x 256 f32 rows from a ``GeneratorChunkSource`` of 763
    chunks (views of the north star's pool, binomial labels from
    ``seed``), through the estimator's streaming fit function handed a
    ``StreamInputs``. The first and the last evaluation's (f, g) are held
    against their f64 truth at the same w (the pool blocks counted as often
    as they back a chunk, plus the last chunk's prefix) at the streamed
    band (``LrTruth``); the model against the f64 reference fit of the
    same rows. One label, moments and variance pass, 763 K3 launches an
    objective pass, peak device memory under STREAM_PEAK_MAX. Returns the
    K3 launches."""
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.core import StreamInputs
    from spark_rapids_ml_tpu_torch.data.chunks import GeneratorChunkSource

    dev = torch.device("cuda:0")
    N, CH = STREAM_ROWS, STREAM_CHUNK_ROWS
    n_chunks = -(-N // CH)
    last = N - (n_chunks - 1) * CH
    pool, _, pool_h, _ = north_star_pool(torch, seed, dev)
    yb = north_star_labels(torch, pool, seed)
    yb_h = yb.cpu().numpy()
    order = np.random.default_rng(seed + 31).integers(0, STREAM_POOL_BLOCKS, size=n_chunks)
    counts = np.bincount(order[:-1], minlength=STREAM_POOL_BLOCKS)
    blocks = [(pool[b], yb[b], int(counts[b])) for b in range(STREAM_POOL_BLOCKS)] + [
        (pool[order[-1], :last], yb[order[-1], :last], 1)]

    def gen(start, count, _seed):
        b = order[start // CH]
        return pool_h[b, :count], yb_h[b, :count]

    inputs = StreamInputs(source=GeneratorChunkSource(gen, N, E2E_D, has_label=True), device=dev, n_rows=N,
                          n_features=E2E_D, dtype=torch.float32, chunk_rows=CH)
    est = LogisticRegression(regParam=STREAM_LR_REG, maxIter=NORTH_STAR_LR_ITER)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st.reset_ingest_report()
    k0 = lk.logreg_loss_grad.launches
    rss0 = rss_bytes()
    with record_streamed_fit(st, lk) as rec:
        model, t_fit = _timed(torch, lambda: est._create_model(est._get_streaming_fit_func(None)(
            inputs, dict(est._tpu_params))))
    peak = torch.cuda.max_memory_allocated(dev) - base
    k = lk.logreg_loss_grad.launches - k0
    rep = st.last_ingest_report()
    passes = rep["passes"]
    mom = rec["moments"]
    # each evaluation against its f64 truth at the fit's own moments
    truth_fit = LrTruth(torch, lk, blocks, mom["mean"], mom["inv_std"], K=1, l2=STREAM_LR_REG, chunk=CH,
                        n_chunks=n_chunks)
    held_evals = []
    for i in sorted({0, len(rec["evals"]) - 1}):
        w, f, g = rec["evals"][i]
        F, G, bands = truth_fit(w, bands=True)
        ef, eg = bands["streamed"]
        held_evals.append({"eval": i, "f": f, "f_f64": F, "f_err": abs(f - F), "f_tol": ef,
                           "g_max_abs_err": float(np.abs(g - G).max()), "g_err_over_tol": float(
                               (np.abs(g - G) / eg).max()), "g_tol_max": float(eg.max())})
        check(abs(f - F) <= ef and (np.abs(g - G) <= eg).all(),
              f"north-star LogReg evaluation {i} off its f64 truth: {held_evals[-1]}")
    ref, t_ref = _timed(torch, lambda: lr_reference_fit(
        torch, blocks, lk, K=1, l2=STREAM_LR_REG, chunk=CH, n_chunks=n_chunks, max_iter=NORTH_STAR_LR_ITER))
    truth = ref[0]
    held = hold_fits(torch, *ref, {"streamed": model}, "north-star LogReg")
    row = {"phase": "streamed", "check": "north_star_logreg", "rows": N, "d": E2E_D, "chunks": n_chunks,
           "last_chunk_rows": last, "maxIter": NORTH_STAR_LR_ITER, "regParam": STREAM_LR_REG,
           "label_mean": float(sum(c * float(y.sum()) for _, y, c in blocks) / N), "fit_s": t_fit,
           "fit_rows_per_s": N / t_fit, "passes": passes, "pass_s": rep["pass_s"],
           "objective_pass_s": rep["pass_s"]["objective"] / passes["objective"],
           "pass_gb_per_s": rep["bytes"] / rep["wall_s"] / 1e9, "n_iter": model.n_iter_,
           "evals": len(rec["evals"]), "stop": "maxIter" if model.n_iter_ == NORTH_STAR_LR_ITER else "tol",
           "peak_device_bytes": peak, "peak_max": STREAM_PEAK_MAX, "host_rss_growth_bytes": rss_bytes() - rss0,
           "logreg_loss_grad_launches": k, "plain_calls": rec["plain_calls"], "held_evals": held_evals,
           "reference_fit_s": t_ref, **held, "ingest": rep}
    emit(row)
    check(passes.get("labels") == 1 and passes.get("moments") == 1 and passes.get("variance") == 1
          and k == n_chunks * passes["objective"] and passes["objective"] == len(rec["evals"]),
          f"north-star LogReg: passes {passes}, {k} K3 launches (want {n_chunks} an objective pass)")
    check(rec["plain_calls"] == 0, "north-star LogReg: K3's plain version ran on the card's path")
    check(peak < STREAM_PEAK_MAX, f"north-star LogReg: peak device memory {peak} >= {STREAM_PEAK_MAX}")
    del pool, yb, blocks, truth, truth_fit
    torch.cuda.empty_cache()
    return k


def phase_stream_logreg(torch, X_host, y_host, seed):
    """The streamed LogisticRegression: (f) K3 at its chunk shapes, (g)
    binomial 12M x 256 streamed vs resident, (h) 64 classes on the
    logreg_many rows, (j) the sparse opt-in on real-sim's shape against
    the resident dense fit, (k) the north star. Returns K3's measurements
    at the chunk shapes and the launches {kernels-line row: {path: n}}."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk
    from spark_rapids_ml_tpu_torch.ops import streaming as st

    t = time.perf_counter()
    Xm, ym, _ = many_data(torch, X_host, seed)
    Xs, ys = sparse_realsim(seed)
    Xd = Xs.toarray()
    meas = phase_stream_k3(torch, lk, X_host, y_host, Xm, ym, Xs, ys, seed)
    rows_codes = {lk._k3_variant(E2E_D, 1, False)}
    route_codes = {lk._k3_variant(LOGREG_MANY_D, LOGREG_MANY_CLASSES, True)}
    cluster_codes = {lk._k3_variant(SPARSE_D, 1, False, aligned) for aligned in (True, False)}
    launches = {"logreg_loss_grad": {}, "logreg_loss_grad_route": {}, "logreg_loss_grad_cluster": {},
                "logreg_loss_grad_stream_rows": {}, "logreg_loss_grad_stream_route": {},
                "logreg_loss_grad_stream_cluster": {}}
    k_s, k_r, _, _ = stream_vs_resident_lr(torch, lk, st, X_host, y_host, K=1, what="logreg_streamed_vs_resident",
                                           kernel="the row-per-warp kernel", codes=rows_codes, seed=seed)
    launches["logreg_loss_grad_stream_rows"]["logreg_streamed"] = k_s
    launches["logreg_loss_grad"]["logreg_streamed_resident"] = k_r
    k_s, k_r, m_s, m_r = stream_vs_resident_lr(torch, lk, st, Xm, ym, K=LOGREG_MANY_CLASSES,
                                               what="logreg_many_streamed_vs_resident", kernel="the route",
                                               codes=route_codes, seed=seed)
    # the two models' transforms of all the rows: equal predictions but
    # where the resident model's two largest logits are a near tie
    df_m = DataFrame({"features": Xm})
    out_s, out_r = m_s.transform(df_m), m_r.transform(df_m)
    raw = out_r.column("rawPrediction")
    top2 = np.partition(raw, -2, axis=1)[:, -2:]
    diff = out_s.column("prediction") != out_r.column("prediction")
    bad = int((diff & (np.abs(top2[:, 1] - top2[:, 0]) > MANY_NEAR_TIE)).sum())
    emit({"phase": "streamed", "check": "logreg_many_streamed_predictions", "rows": Xm.shape[0],
          "agreement": float(1.0 - diff.mean()), "disagreements_past_near_tie": bad, "near_tie": MANY_NEAR_TIE})
    check(np.isfinite(out_s.column("probability")).all() and bad == 0,
          f"64-class streamed vs resident: {bad} predictions differ past a near tie")
    del out_s, out_r, raw, df_m
    launches["logreg_loss_grad_stream_route"]["logreg_many_streamed"] = k_s
    launches["logreg_loss_grad_route"]["logreg_many_streamed_resident"] = k_r
    del Xm, ym
    k_s, k_r, _, _ = stream_vs_resident_lr(torch, lk, st, Xd, ys, K=1, what="logreg_sparse_optin_vs_dense",
                                           kernel="the cluster kernel", codes=cluster_codes, seed=seed,
                                           reg=STREAM_LR_REG, sparse=Xs)
    launches["logreg_loss_grad_stream_cluster"]["logreg_sparse_streamed"] = k_s
    launches["logreg_loss_grad_cluster"]["logreg_realsim_dense_resident"] = k_r
    del Xd, Xs
    launches["logreg_loss_grad_stream_rows"]["north_star_logreg"] = phase_north_star_logreg(torch, lk, st, seed)
    emit({"phase": "streamed", "check": "logreg_done", "s": time.perf_counter() - t, "launches": launches})
    return meas, launches


# ---------------------------------------------------------------------------
# the streamed KMeans: Lloyd and the k-means|| seeding as chunked passes, K2
# on every chunk of each Lloyd, cost and candidate-count pass
# ---------------------------------------------------------------------------

# the reference's KMeans benchmark config (BASELINE.md:23, from
# databricks/run_benchmark.sh:46-55): k=1000, tol=1e-20, random init; its
# maxIter=30 cut to STREAM_KM_ITER at 100M, where every iteration is one
# pass of ~9-14 s (at 5 iterations the whole script took 984 s of its
# 1,200 on an H100 80GB HBM3 at 700 W; 3 cut to 2 when the tuning phase (r)
# joined the run)
STREAM_KM_K = 1000
STREAM_KM_ITER = 2
STREAM_KM_TOL = 1e-20
# the bench's KMeans (bench.py: k = E2E_CENTRES, maxIter=10) on the 12M
# rows, streamed and resident: k-means|| at its maxIter (the resident fit
# is the e2e phase's), random init cut to STREAM_KM_WALK_ITER
STREAM_KM_E2E_ITER = 10
STREAM_KM_WALK_ITER = 5
# the k-means|| candidate count K2 is timed at: 1 + 2 steps x 2k draws at
# oversampling 2 (k of the candidate-count pass)
STREAM_KM_CANDS = 4097
# timed calls of K2 at each chunk shape
STREAM_K2_REPS = 10
# the share of the 12M rows two KMeans walks from the same
# seeds (streamed, resident) must predict alike (the card-vs-CPU agreement
# floor of the 64-class LogisticRegression, MANY_AGREE_MIN); the rows that
# differ are reported by whether their squared distances to the two
# centres lie within KM_NEAR_TIE of the nearer, in one model or the other
KM_AGREE_MIN = 0.995
KM_NEAR_TIE = 1e-3
# k-means|| streamed vs resident: an ulp of distance may flip one draw near
# its threshold, so the cost is held as the card-vs-CPU fits hold it
# (phase_subset)
KM_PLUSPLUS_COST_TOL = 0.02


@contextlib.contextmanager
def record_kmeans_fit(kk):
    """While open: the seeds a KMeans fit starts from (the outermost
    seeding call's output), the calls of K2's plain version (none may come
    from a card path), the operand copies K2's wrapper makes
    (``lloyd_operands``: none for a fresh 256-wide chunk), and the K2
    launches of the streamed chunk steps by pass kind, each read around its
    step (``lloyd``: the Lloyd and cost passes' ``kmeans_chunk_step``;
    ``count``: the candidate-count pass's ``count_closest_chunk_step``,
    with the candidate counts it ran at); on leaving, all K2 launches made
    inside."""
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.ops import streaming as st

    rec = {"centers0": None, "plain_calls": 0, "operand_copies": 0, "launches": 0,
           "pass_launches": {"lloyd": 0, "count": 0}, "count_k": []}
    saved = {name: KMeans.__dict__[name] for name in ("_seed_random", "_seed_scalable_kmeanspp")}
    real_plain, real_ops = kk.lloyd_step_plain, kk.lloyd_operands
    steps = {"lloyd": ("kmeans_chunk_step", st.kmeans_chunk_step),
             "count": ("count_closest_chunk_step", st.count_closest_chunk_step)}
    k0 = kk.lloyd_step.launches

    def seeding(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            rec["centers0"] = np.array(out)
            return out
        return staticmethod(wrapper)

    def plain(*a, **kw):
        rec["plain_calls"] += 1
        return real_plain(*a, **kw)

    def operands(X, C):
        out = real_ops(X, C)
        rec["operand_copies"] += int(out[0] is not X) + int(out[1] is not C)
        return out

    def counted(kind, fn):
        def step(acc, X, mask, C):
            before = kk.lloyd_step.launches
            out = fn(acc, X, mask, C)
            rec["pass_launches"][kind] += kk.lloyd_step.launches - before
            if kind == "count" and C.shape[0] not in rec["count_k"]:
                rec["count_k"].append(int(C.shape[0]))
            return out
        return step

    for name, sm in saved.items():
        setattr(KMeans, name, seeding(sm.__func__))
    for kind, (name, fn) in steps.items():
        setattr(st, name, counted(kind, fn))
    kk.lloyd_step_plain, kk.lloyd_operands = plain, operands
    try:
        yield rec
    finally:
        for name, sm in saved.items():
            setattr(KMeans, name, sm)
        for name, fn in steps.values():
            setattr(st, name, fn)
        kk.lloyd_step_plain, kk.lloyd_operands = real_plain, real_ops
        rec["launches"] = kk.lloyd_step.launches - k0


def phase_stream_k2(torch, kk, X_host, seed):
    """(l) K2 at the shapes a streamed KMeans gives it (``auto_chunk_rows``'
    131,072 x 256 chunk): k = 1,024 (the bench's Lloyd passes on the 12M
    rows), k = 1,000 (the reference's config at 100M) and k = 4,097 (the
    k-means|| candidate count), each held with its controls and timed as a
    median device time beside its plain version and one matmul + argmin +
    ``index_add_``, with its bound; each also on its zero-padded last chunk
    (the 12M rows' 72,448 at k = 1,024 and 4,097, the 100M rows' 123,136 at
    k = 1,000; m = 0 past them), where the counts must add up to the real
    rows. A chunk must reach the kernel as it is (``lloyd_operands`` makes
    no copy). Returns the measurements by kernels-line row."""
    dev = torch.device("cuda:0")
    CH = STREAM_CHUNK_ROWS
    n = X_host.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 34)
    first = torch.from_numpy(X_host[:CH]).to(dev)
    ones = torch.ones(CH, device=dev)

    def rows(k):
        return first[torch.randint(0, CH, (k,), generator=g, device=dev)].contiguous()

    # a Lloyd iteration's centres (rows moved off the data), the random
    # init's seeds, the k-means|| candidates (rows)
    cents = {E2E_CENTRES: (rows(E2E_CENTRES) + 0.1 * torch.randn(E2E_CENTRES, E2E_D, generator=g, device=dev)),
             STREAM_KM_K: rows(STREAM_KM_K), STREAM_KM_CANDS: rows(STREAM_KM_CANDS)}
    last_12m = n - (-(-n // CH) - 1) * CH
    last_100m = STREAM_ROWS - (-(-STREAM_ROWS // CH) - 1) * CH
    out = {}
    for k, C in cents.items():
        name = f"lloyd_step_stream_k{k}"
        Xk, Ck = kk.lloyd_operands(first, C)
        check(Xk is first and Ck is C, f"{name}: K2's wrapper copies a chunk operand")
        r = check_lloyd_step(torch, kk, first, ones, C, STREAM_K2_REPS, control=True, timer=median_device_ms)
        nv, src = (last_100m, X_host[:last_100m]) if k == STREAM_KM_K else (last_12m, X_host[n - last_12m:])
        Xl = torch.zeros((CH, E2E_D), device=dev)
        Xl[:nv] = torch.from_numpy(src).to(dev)
        ml = torch.zeros(CH, device=dev)
        ml[:nv] = 1.0
        rl = check_lloyd_step(torch, kk, Xl, ml, C, 0)
        counted = int(kk.lloyd_step(Xl, ml, C)[1].sum())
        check(counted == nv, f"{name}: the last chunk's counts add up to {counted}, not its {nv} rows")
        r["last_chunk"] = {"n_valid": nv, "rows_counted": counted, **{key: rl[key] for key in (
            "max_abs_err", "err_over_tol", "count_changes", "near_tie_rows", "cost_err_over_tol")}}
        r["operands_as_given"] = True
        emit({"phase": "kernels", "kernel": "lloyd_step", "shape": name,
              **{key: v for key, v in r.items() if key != "controls"},
              "controls": [(c["control"], c["err_over_tol"]) for c in r["controls"]]})
        out[name] = r
        del Xl, ml
    del first, ones, cents
    torch.cuda.empty_cache()
    return out


def km_fit(torch, kk, df, **kw):
    """A KMeans fit of ``df`` with ``kw``, recorded (``record_kmeans_fit``):
    (model, seconds, record)."""
    from spark_rapids_ml_tpu_torch.clustering import KMeans

    with record_kmeans_fit(kk) as rec:
        model, t = _timed(torch, lambda: KMeans(**kw).fit(df))
    return model, t, rec


def check_streamed_km(model, rec, n_chunks, what):
    """A streamed KMeans fit's passes and K2 launches: one launch a chunk
    of each Lloyd and cost pass, and of each candidate-count pass, each
    counted around its chunk step, and no other; none of K2's plain
    version, no operand copy, one Lloyd pass an iteration and one cost
    pass. Returns the passes."""
    passes = model._ingest_report["passes"]
    lloyd = passes.get("lloyd", 0) + passes.get("cost", 0)
    pl = rec["pass_launches"]
    check(pl["lloyd"] == n_chunks * lloyd and pl["count"] == n_chunks * passes.get("seed_count", 0)
          and rec["launches"] == pl["lloyd"] + pl["count"],
          f"{what}: K2 launches {rec['launches']} ({pl}) over passes {passes} of {n_chunks} chunks")
    check(rec["plain_calls"] == 0 and rec["operand_copies"] == 0,
          f"{what}: K2's plain version ran {rec['plain_calls']} times, {rec['operand_copies']} operand copies")
    check(passes.get("cost") == 1 and passes.get("lloyd", 0) == model.numIter, f"{what}: passes {passes}")
    return passes


def prediction_agreement(torch, X_host, models, near_tie=KM_NEAR_TIE):
    """The share of equal predictions of two KMeans models over the
    transformed rows, and of the rows that differ, those past a near tie:
    their squared distances (f64) to the two predicted centres differ by
    more than ``near_tie`` of the nearer in both models (with the largest
    such share of the differing rows)."""
    from spark_rapids_ml_tpu_torch import DataFrame

    df = DataFrame({"features": X_host})
    (pa, ta), (pb, tb) = (_timed(torch, lambda: np.asarray(m.transform(df).column("prediction")))
                          for m in models)
    diff = np.nonzero(pa != pb)[0]
    bad, worst = 0, 0.0
    for lo in range(0, len(diff), 1 << 16):
        rows = diff[lo:lo + (1 << 16)]
        x = X_host[rows].astype(np.float64)
        gaps = []
        for m in models:
            c = np.asarray(m.cluster_centers_, np.float64)
            da, db = ((x - c[pa[rows]]) ** 2).sum(1), ((x - c[pb[rows]]) ** 2).sum(1)
            gaps.append(np.abs(da - db) / np.maximum(np.minimum(da, db), 1e-30))
        gap = np.minimum(*gaps)
        bad += int((gap > near_tie).sum())
        worst = max(worst, float(gap.max()))
    return {"agreement": float(1.0 - len(diff) / len(pa)), "rows_differing": int(len(diff)),
            "differing_past_near_tie": bad, "near_tie": near_tie, "largest_relative_gap": worst,
            "transform_s": [ta, tb]}


def km_centre_bands(torch, ref, C0, n, chunk, n_chunks):
    """f64 centres after one Lloyd iteration from ``C0`` and, entry by
    entry, the bands of a streamed and of a resident iteration around them:
    each centre's sums within K2's band (streamed: each chunk's, then an f32
    sum of ``n_chunks`` partials; resident: one launch over ``n`` rows) and
    its near ties' slack, over the f64 count, plus the count's change
    across the near ties and the rounding of the update (streamed: f64 then
    one rounding to f32; resident: an f32 division). A centre whose near
    ties reach its count has no band (NaN)."""
    f64 = torch.float64
    N = ref["counts"].to(f64)
    near = ref["near"].to(f64)
    Nc = torch.clamp(N, min=1.0)[:, None]
    C0 = C0.to(f64)
    c = torch.where(N[:, None] > 0, ref["sums"] / Nc, C0)
    common = ref["slack"] / Nc + c.abs() * (near[:, None] / Nc)
    e_s = U32 * ((TOL_TERMS + n_chunks) * ref["T"] + TOL_WALK * chunk ** 0.5 * ref["A"]) / Nc + common \
        + U32 * c.abs()
    e_r = U32 * (TOL_TERMS * ref["T"] + TOL_WALK * n ** 0.5 * ref["sums"].abs()) / Nc + common + 2.0 * U32 * c.abs()
    unheld = (near >= N) & ~((N == 0) & (near == 0))
    e_s[unheld], e_r[unheld] = float("nan"), float("nan")
    return c, e_s, e_r


def centre_ratio(torch, centres, c, e):
    """(max |centres - c|, max |centres - c| / e) over the centres with a
    band; an error where the band is 0 gives an infinite ratio."""
    err = (torch.from_numpy(np.asarray(centres, np.float64)).to(c.device) - c).abs()
    ok = ~torch.isnan(e).any(dim=1)
    ratio = torch.where(err > 0, err / e, torch.zeros_like(err))[ok]
    return float(err[ok].max()), float(ratio.max())


def phase_stream_kmeans_vs_resident(torch, kk, X_host, seed, km_resident=None):
    """(m) The bench's KMeans(k=1024, seed) on the 12M x 256 host rows,
    streamed (``streaming=True``: an ``ArrayChunkSource`` of 92 chunks) and
    resident (maxIter STREAM_KM_WALK_ITER from random seeds, the bench's 10
    with k-means||). Random init: both fits start from the same seeds,
    bit for bit; one Lloyd iteration (``maxIter=1``) of each is held
    against the f64 iteration from those seeds (``km_centre_bands``); the
    STREAM_KM_WALK_ITER-iteration fits stop at the same iteration (or a shift lies within
    rounding of tol²), their costs agree within the two sides' per-pass
    cost band compounded over the passes, their centres within the
    one-iteration bands compounded over the iterations, and at least
    KM_AGREE_MIN of their predictions are equal (the rows that differ
    reported by near tie: a near-tie flip in one iteration moves the next
    iteration's boundary, so the walks part in blobs that two seeds split). k-means|| (the default): the cost within
    KM_PLUSPLUS_COST_TOL of the resident fit's (``km_resident``, the e2e
    phase's model, where given). Each streamed fit: one K2 launch a chunk
    of each device pass, none of its plain version. Reports fit seconds,
    passes, launches and both fits' seeding split. Returns the K2 launches
    {kernels-line row: {path: n}} and the candidate counts the k-means||
    fit's count pass ran at (its launches sit in the k = STREAM_KM_CANDS
    row, which is timed at that nominal count)."""
    from spark_rapids_ml_tpu_torch import DataFrame

    dev = torch.device("cuda:0")
    n = X_host.shape[0]
    CH = STREAM_CHUNK_ROWS
    n_chunks = -(-n // CH)
    df = DataFrame({"features": X_host})
    lloyd_row, cand_row = f"lloyd_step_stream_k{E2E_CENTRES}", f"lloyd_step_stream_k{STREAM_KM_CANDS}"
    launches = {"lloyd_step": {}, lloyd_row: {}, cand_row: {}}
    base = {"k": E2E_CENTRES, "seed": seed, "initMode": "random"}
    stream = {"streaming": True, "stream_chunk_rows": CH}

    # one Lloyd iteration from the same seeds, each held against the f64 one
    s1, t_s1, rec_s1 = km_fit(torch, kk, df, maxIter=1, **base, **stream)
    r1, t_r1, rec_r1 = km_fit(torch, kk, df, maxIter=1, **base)
    check_streamed_km(s1, rec_s1, n_chunks, "streamed KMeans, one iteration")
    C0 = rec_s1["centers0"]
    check(C0 is not None and np.array_equal(C0, rec_r1["centers0"]),
          "streamed vs resident KMeans: the random seeds differ")
    Xd = torch.from_numpy(X_host).to(dev)
    ref, t_ref = _timed(torch, lambda: lloyd_reference(torch, kk, Xd, torch.ones(n, device=dev),
                                                       torch.from_numpy(C0).to(dev), chunk=CH))
    del Xd
    torch.cuda.empty_cache()
    c1, e_s, e_r = km_centre_bands(torch, ref, torch.from_numpy(C0).to(dev), n, CH, n_chunks)
    err_s, ratio_s = centre_ratio(torch, s1.cluster_centers_, c1, e_s)
    err_r, ratio_r = centre_ratio(torch, r1.cluster_centers_, c1, e_r)
    one = {"streamed_max_abs_err": err_s, "streamed_err_over_tol": ratio_s, "resident_max_abs_err": err_r,
           "resident_err_over_tol": ratio_r, "near_tie_rows": ref["near_rows"],
           "centres_without_band": int(torch.isnan(e_s).any(dim=1).sum()),
           "streamed_vs_resident_max_abs_diff": float(np.abs(s1.cluster_centers_ - r1.cluster_centers_).max()),
           "streamed_fit_s": t_s1, "resident_fit_s": t_r1, "reference_s": t_ref}
    emit({"phase": "streamed", "check": "kmeans_one_iteration", "rows": n, "k": E2E_CENTRES, **one})
    check(ratio_s <= 1.0 and ratio_r <= 1.0, f"one Lloyd iteration off its f64 truth: {one}")
    launches[lloyd_row]["kmeans_streamed_1iter"] = rec_s1["launches"]
    launches["lloyd_step"]["kmeans_resident_1iter"] = rec_r1["launches"]

    # the walks
    s10, t_s10, rec_s10 = km_fit(torch, kk, df, maxIter=STREAM_KM_WALK_ITER, **base, **stream)
    r10, t_r10, rec_r10 = km_fit(torch, kk, df, maxIter=STREAM_KM_WALK_ITER, **base)
    passes = check_streamed_km(s10, rec_s10, n_chunks, "streamed KMeans")
    check(np.array_equal(rec_s10["centers0"], C0) and np.array_equal(rec_r10["centers0"], C0),
          "the walks start from other seeds")
    tol2 = 1e-4 ** 2
    sh_s, sh_r = s10._fit_report["shifts"], r10._fit_report["shifts"]
    walk = {"n_iter": [s10.numIter, r10.numIter], "stop": "maxIter" if min(s10.numIter, r10.numIter) == (
        STREAM_KM_WALK_ITER) else "tol", "shifts_streamed": sh_s, "shifts_resident": sh_r}
    if s10.numIter != r10.numIter:
        i = min(s10.numIter, r10.numIter) - 1
        walk["iteration_apart"] = i + 1
        check(abs(sh_s[i] - sh_r[i]) <= 0.5 * tol2, f"the walks stop apart at iteration {i + 1}, their shifts "
                                                    f"{sh_s[i]!r} / {sh_r[i]!r} not within rounding of tol²")
    iters = max(s10.numIter, r10.numIter)
    cost_pass = U32 * ((2.0 * TOL_TERMS + n_chunks) * float(ref["T_cost"])
                       + TOL_WALK * (CH ** 0.5 + n ** 0.5) * float(ref["cost"])) + 2.0 * float(ref["slack_cost"])
    cost_tol = (iters + 1) * cost_pass
    d_cost = abs(s10.trainingCost - r10.trainingCost)
    band = float(torch.nan_to_num(e_s + e_r, nan=0.0).max()) * iters
    dc = np.abs(s10.cluster_centers_.astype(np.float64) - r10.cluster_centers_)
    pred = prediction_agreement(torch, X_host, (s10, r10))
    walk.update({"cost": [s10.trainingCost, r10.trainingCost], "cost_abs_diff": d_cost, "cost_tol": cost_tol,
                 "cost_rel_diff": d_cost / r10.trainingCost, "centre_max_abs_diff": float(dc.max()),
                 "centre_band_compounded": band, "centres_beyond_band": int((dc.max(axis=1) > band).sum()),
                 "predictions": pred, "streamed_fit_s": t_s10, "resident_fit_s": t_r10,
                 "streamed_rows_per_s": n / t_s10, "passes": passes,
                 "lloyd_pass_s": s10._ingest_report["pass_s"]["lloyd"] / passes["lloyd"],
                 "lloyd_step_launches": rec_s10["launches"], "resident_launches": rec_r10["launches"],
                 "fit_report_streamed": s10._fit_report, "fit_report_resident": r10._fit_report,
                 "ingest": s10._ingest_report})
    emit({"phase": "streamed", "check": "kmeans_streamed_vs_resident", "init": "random", "rows": n,
          "k": E2E_CENTRES, "maxIter": STREAM_KM_WALK_ITER, "chunks": n_chunks, **walk})
    check(d_cost <= cost_tol, f"streamed vs resident KMeans: costs {d_cost!r} apart (tol {cost_tol!r})")
    check(np.isfinite(s10.cluster_centers_).all() and pred["agreement"] >= KM_AGREE_MIN,
          f"streamed vs resident KMeans: {pred['agreement']} of predictions equal, below {KM_AGREE_MIN}")
    check(walk["centres_beyond_band"] == 0, f"streamed vs resident KMeans: {walk['centres_beyond_band']} centres "
                                            f"beyond the compounded band {band!r}")
    launches[lloyd_row]["kmeans_streamed"] = rec_s10["launches"]
    launches["lloyd_step"]["kmeans_resident"] = rec_r10["launches"]

    # k-means||, the default init
    kw = {"k": E2E_CENTRES, "seed": seed, "maxIter": STREAM_KM_E2E_ITER}
    sp, t_sp, rec_sp = km_fit(torch, kk, df, **kw, **stream)
    passes = check_streamed_km(sp, rec_sp, n_chunks, "streamed k-means||")
    check(passes.get("seed_count") == 1 and passes.get("seed_min_d2", 0) >= 1, f"streamed k-means||: {passes}")
    if km_resident is None:
        rp, t_rp, rec_rp = km_fit(torch, kk, df, **kw)
        launches["lloyd_step"]["kmeans_resident_kmeanspp"] = rec_rp["launches"]
    else:
        rp, t_rp = km_resident
    rel = abs(sp.trainingCost - rp.trainingCost) / rp.trainingCost
    emit({"phase": "streamed", "check": "kmeans_streamed_vs_resident", "init": "k-means||", "rows": n,
          "k": E2E_CENTRES, "maxIter": STREAM_KM_E2E_ITER, "cost": [sp.trainingCost, rp.trainingCost],
          "cost_rel_diff": rel, "cost_tol": KM_PLUSPLUS_COST_TOL, "n_iter": [sp.numIter, rp.numIter],
          "streamed_fit_s": t_sp, "resident_fit_s": t_rp, "resident_from_e2e": km_resident is not None,
          "passes": passes, "pass_s": sp._ingest_report["pass_s"], "lloyd_step_launches": rec_sp["launches"],
          "lloyd_pass_launches": rec_sp["pass_launches"]["lloyd"],
          "candidate_count_launches": rec_sp["pass_launches"]["count"], "candidates": rec_sp["count_k"],
          "fit_report_streamed": sp._fit_report,
          "fit_report_resident": rp._fit_report, "ingest": sp._ingest_report})
    check(rel <= KM_PLUSPLUS_COST_TOL, f"streamed vs resident k-means||: cost {rel:.3g} apart")
    launches[lloyd_row]["kmeans_streamed_kmeanspp"] = rec_sp["pass_launches"]["lloyd"]
    launches[cand_row]["kmeans_streamed_kmeanspp"] = rec_sp["pass_launches"]["count"]
    return launches, rec_sp["count_k"]


def lloyd_walk64(torch, kk, X, m, C0, iters):
    """The f64 Lloyd walk from ``C0`` over the rows of ``X`` each counted
    ``m`` times (``lloyd_reference``, weighted) for ``iters`` iterations
    (an empty cluster keeps its centre), then its cost: (centres, cost)."""
    C = C0.to(torch.float64)
    for _ in range(iters):
        r = lloyd_reference(torch, kk, X, m, C, chunk=STREAM_CHUNK_ROWS, weighted=True)
        counts = r["counts"].to(torch.float64)
        C = torch.where(counts[:, None] > 0, r["sums"] / torch.clamp(counts, min=1.0)[:, None], C)
    return C, float(lloyd_reference(torch, kk, X, m, C, chunk=STREAM_CHUNK_ROWS, weighted=True)["cost"])


def phase_north_star_kmeans(torch, kk, st, X_host, seed):
    """(n) The reference's KMeans(k=1000, tol=1e-20, initMode="random"),
    maxIter cut to STREAM_KM_ITER, on 100,000,000 x 256 f32 rows from a
    ``GeneratorChunkSource`` of 763 chunks, each a view of one of the full
    131,072-row chunks of the 12M blob rows (the block of each drawn from
    ``seed``; the last chunk a 123,136-row prefix), through the estimator's
    streaming fit function handed a ``StreamInputs``. Every pass's f64
    truth is ``lloyd_reference`` on the pool rows with their multiplicities
    as row weights. Held: the seeds equal the pool rows that ``seed``'s
    ``rng.choice`` names, bit for bit (the gather pass, its offsets and the
    prefix); a maxIter=0 fit's cost (one cost pass at the seeds) against
    its truth at K2's band widened for an f32 sum of 763 chunk partials;
    the fit's cost against an f64 walk's from the same seeds, within that
    pass band compounded over its passes, and at most the seeds' cost; one
    K2 launch a chunk of each pass, none of its plain version; peak device
    memory under STREAM_PEAK_MAX. Returns the K2 launches by path."""
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.core import StreamInputs
    from spark_rapids_ml_tpu_torch.data.chunks import GeneratorChunkSource

    dev = torch.device("cuda:0")
    N, CH = STREAM_ROWS, STREAM_CHUNK_ROWS
    n_chunks = -(-N // CH)
    last = N - (n_chunks - 1) * CH
    n_blocks = X_host.shape[0] // CH
    check(n_blocks >= 1 and last <= CH, f"north-star KMeans: {X_host.shape[0]} rows make no 131,072-row block")
    pool_h = X_host[:n_blocks * CH]
    order = np.random.default_rng(seed + 35).integers(0, n_blocks, size=n_chunks)
    mult = np.repeat(np.bincount(order[:-1], minlength=n_blocks), CH).astype(np.float32)
    mult[order[-1] * CH:order[-1] * CH + last] += 1.0
    check(float(mult.sum(dtype=np.float64)) == N, "north-star KMeans: the multiplicities do not count 100M rows")

    def gen(start, count, _seed):
        b = order[start // CH]
        return pool_h[b * CH:b * CH + count], None

    inputs = StreamInputs(source=GeneratorChunkSource(gen, N, E2E_D), device=dev, n_rows=N, n_features=E2E_D,
                          dtype=torch.float32, chunk_rows=CH)
    # the seeds the fit must gather: the seed's rng.choice, mapped through
    # the chunk -> block map
    idx = np.sort(np.random.default_rng(seed or 0).choice(N, size=STREAM_KM_K, replace=False))
    C0 = pool_h[order[idx // CH] * CH + idx % CH]
    t = time.perf_counter()
    Xp = torch.from_numpy(pool_h).to(dev)
    md = torch.from_numpy(mult).to(dev)
    C0d = torch.from_numpy(C0).to(dev)
    ref = lloyd_reference(torch, kk, Xp, md, C0d, chunk=CH, weighted=True)
    walk_C, walk_cost = lloyd_walk64(torch, kk, Xp, md, C0d, STREAM_KM_ITER)
    walk_C = walk_C.cpu().numpy()
    t_truth = time.perf_counter() - t
    del Xp, md
    torch.cuda.empty_cache()
    check(int(ref["counts"].sum()) == N, "north-star KMeans: the truth does not count 100M rows")

    def streamed_fit(max_iter):
        est = KMeans(k=STREAM_KM_K, maxIter=max_iter, tol=STREAM_KM_TOL, initMode="random", seed=seed)
        st.reset_ingest_report()
        with record_kmeans_fit(kk) as rec:
            model, t_fit = _timed(torch, lambda: est._create_model(est._get_streaming_fit_func(None)(
                inputs, dict(est._tpu_params))))
        model._ingest_report = st.last_ingest_report()
        return model, t_fit, rec

    # one pass: the maxIter=0 fit's cost at the seeds
    m0, t0, rec0 = streamed_fit(0)
    check(np.array_equal(m0.cluster_centers_, C0), "north-star KMeans: the seeds are not the rows the seed names")
    err0, ratio0 = held(torch, torch.tensor(m0.trainingCost, dtype=torch.float64), ref["cost"], ref["T_cost"], CH,
                        ref["slack_cost"], terms=TOL_TERMS + n_chunks, walk=TOL_WALK * CH ** 0.5)
    check_streamed_km(m0, rec0, n_chunks, "north-star KMeans, maxIter=0")
    emit({"phase": "streamed", "check": "north_star_kmeans_seeds", "rows": N, "k": STREAM_KM_K, "chunks": n_chunks,
          "last_chunk_rows": last, "pool_blocks": n_blocks, "seeds_equal": True, "cost": m0.trainingCost,
          "cost_f64": float(ref["cost"]), "cost_abs_err": err0, "cost_err_over_tol": ratio0,
          "near_tie_rows": ref["near_rows"], "fit_s": t0, "truth_s": t_truth, "passes": m0._ingest_report["passes"],
          "pass_s": m0._ingest_report["pass_s"], "lloyd_step_launches": rec0["launches"],
          "fit_report": m0._fit_report})
    check(ratio0 <= 1.0, f"north-star KMeans: the seeds' cost {m0.trainingCost!r} off its f64 truth "
                         f"{float(ref['cost'])!r} (err/tol {ratio0:.3g})")

    # the fit
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rss0 = rss_bytes()
    model, t_fit, rec = streamed_fit(STREAM_KM_ITER)
    peak = torch.cuda.max_memory_allocated(dev) - base
    rep = model._ingest_report
    passes = check_streamed_km(model, rec, n_chunks, "north-star KMeans")
    pass_tol = U32 * ((TOL_TERMS + n_chunks) * float(ref["T_cost"]) + TOL_WALK * CH ** 0.5 * float(ref["cost"])) \
        + float(ref["slack_cost"])
    cost_tol = (STREAM_KM_ITER + 1) * pass_tol
    d_cost = abs(model.trainingCost - walk_cost)
    dc = np.abs(model.cluster_centers_.astype(np.float64) - walk_C)
    row = {"phase": "streamed", "check": "north_star_kmeans", "rows": N, "d": E2E_D, "k": STREAM_KM_K,
           "maxIter": STREAM_KM_ITER, "tol": STREAM_KM_TOL, "chunks": n_chunks, "fit_s": t_fit,
           "fit_rows_per_s": N / t_fit, "n_iter": model.numIter, "passes": passes, "pass_s": rep["pass_s"],
           "lloyd_pass_s": rep["pass_s"]["lloyd"] / passes["lloyd"],
           "pass_gb_per_s": rep["bytes"] / rep["wall_s"] / 1e9, "cost": model.trainingCost,
           "seed_cost": m0.trainingCost, "walk_cost_f64": walk_cost, "cost_abs_diff": d_cost, "cost_tol": cost_tol,
           "cost_rel_diff": d_cost / walk_cost, "centre_max_abs_diff_vs_walk": float(dc.max()),
           "centre_rel_diff_vs_walk": float(dc.max() / np.abs(walk_C).max()),
           "peak_device_bytes": peak, "peak_max": STREAM_PEAK_MAX, "host_rss_growth_bytes": rss_bytes() - rss0,
           "lloyd_step_launches": rec["launches"], "plain_calls": rec["plain_calls"],
           "fit_report": model._fit_report, "ingest": rep}
    emit(row)
    check(passes == {"seed_rows": 1, "lloyd": STREAM_KM_ITER, "cost": 1}, f"north-star KMeans: passes {passes}")
    check(np.isfinite(model.cluster_centers_).all() and d_cost <= cost_tol,
          f"north-star KMeans: cost {model.trainingCost!r} off the f64 walk's {walk_cost!r} (tol {cost_tol:.4g})")
    check(model.trainingCost <= m0.trainingCost * (1 + 1e-6),
          f"north-star KMeans: cost {model.trainingCost!r} above its seeds' {m0.trainingCost!r}")
    check(peak < STREAM_PEAK_MAX, f"north-star KMeans: peak device memory {peak} >= {STREAM_PEAK_MAX}")
    return {"north_star_kmeans_seeds": rec0["launches"], "north_star_kmeans": rec["launches"]}


def phase_stream_kmeans(torch, X_host, seed, km_resident=None):
    """The streamed KMeans: (l) K2 at its chunk shapes, (m) streamed vs
    resident on the 12M rows, (n) the reference's config at 100M. Returns
    K2's measurements at the chunk shapes and its launches {kernels-line
    row: {path: n}}."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import streaming as st

    t = time.perf_counter()
    meas = phase_stream_k2(torch, kk, X_host, seed)
    launches, cand_k = phase_stream_kmeans_vs_resident(torch, kk, X_host, seed, km_resident)
    meas[f"lloyd_step_stream_k{STREAM_KM_CANDS}"]["main_path_k"] = cand_k
    launches[f"lloyd_step_stream_k{STREAM_KM_K}"] = phase_north_star_kmeans(torch, kk, st, X_host, seed)
    emit({"phase": "streamed", "check": "kmeans_done", "s": time.perf_counter() - t, "launches": launches})
    return meas, launches


# ---------------------------------------------------------------------------
# the streamed path's wire formats and checkpoint/resume
# ---------------------------------------------------------------------------

# rows of the wire and resume phases: the first 12 chunks of the host rows,
# at the main path's full width, as a generator source (16 chunks took the
# two phases 63.4 s on an H100, over their 60 s)
STREAM_WIRE_ROWS = 1_572_864
WIRE_KINDS = ("f32", "f16", "int8", "f8", "auto")
# the JAX package's wire tolerances (tests/test_streaming_wire.py:50-130):
# statistics (here a PCA's mean and explained variance) within f16 2e-3 /
# int8 3e-2 of their largest entry, a PCA's explained variance at rtol 5e-2
# and its components' |cosines| within 5e-2 of 1 at int8, LinearRegression's
# coefficients at atol 1e-2 (f16), KMeans' centres at atol 0.5 (int8; here
# the root mean square of the centres' entries weighted by their rows: a
# centre of a few rows near a tie moves by a row's distance when one row
# flips); e4m3 (3 mantissa bits) held at int8's
WIRE_STAT_TOL = {"f16": 2e-3, "int8": 3e-2, "f8": 3e-2}
WIRE_EV_RTOL = {"f16": 2e-3, "int8": 5e-2, "f8": 5e-2}
WIRE_COS_TOL = 5e-2
WIRE_LINREG_ATOL = 1e-2
WIRE_KM_ATOL = 0.5
# the resume phase: LogisticRegression maxIter 5 and KMeans (random init,
# k = 1,024, tol 1e-20) maxIter 4, each interrupted in the first pass that
# starts after the checkpoint of iteration RESUME_AFTER was committed
RESUME_LR_ITER = 5
RESUME_KM_ITER = 4
RESUME_AFTER = 2


class ResumeInterrupt(Exception):
    """The interruption ``interrupting_source`` raises inside a pass."""


def wire_source(X_host, y, rows):
    """The first ``rows`` host rows (and labels ``y``) as a
    ``GeneratorChunkSource``: each chunk a view, so the generator does not
    set the pace."""
    from spark_rapids_ml_tpu_torch.data.chunks import GeneratorChunkSource

    def gen(start, count, _seed):
        return X_host[start:start + count], None if y is None else y[start:start + count]

    return GeneratorChunkSource(gen, rows, X_host.shape[1], has_label=y is not None)


def committed_iteration(ckpt_dir) -> int:
    """The iteration of the checkpoint committed in ``ckpt_dir`` (its
    manifest), else 0."""
    its = []
    for name in os.listdir(ckpt_dir):
        if name.endswith(".json"):
            with open(os.path.join(ckpt_dir, name)) as f:
                its.append(json.load(f)["iteration"])
    return max(its, default=0)


def interrupting_source(X_host, y, rows, ckpt_dir, after=RESUME_AFTER):
    """``wire_source`` whose every pass that starts after the checkpoint of
    iteration ``after`` was committed in ``ckpt_dir`` raises
    ``ResumeInterrupt`` after its first chunk."""
    src = wire_source(X_host, y, rows)
    real = src.iter_chunks

    def iter_chunks(chunk_rows, dtype=np.float32):
        armed = committed_iteration(ckpt_dir) >= after
        for i, c in enumerate(real(chunk_rows, dtype)):
            if armed and i == 1:
                raise ResumeInterrupt(f"interrupted after the checkpoint of iteration {after}")
            yield c

    src.iter_chunks = iter_chunks
    return src


def stream_fit(torch, st, ests, source, rows, wire=None):
    """``ests`` fitted on ``source`` through the first one's streaming fit
    function (shared, as ``fitMultiple`` shares it) handed a
    ``StreamInputs``, with ``ops.streaming.WIRE_DTYPE`` at ``wire`` where
    given: (models, seconds, the ingest report)."""
    from spark_rapids_ml_tpu_torch.core import StreamInputs

    dev = torch.device("cuda:0")
    inputs = StreamInputs(source=source, device=dev, n_rows=rows, n_features=E2E_D, dtype=torch.float32,
                          chunk_rows=STREAM_CHUNK_ROWS)
    saved = st.WIRE_DTYPE
    st.WIRE_DTYPE = saved if wire is None else wire
    st.reset_ingest_report()
    try:
        fit = ests[0]._get_streaming_fit_func(None)
        models, t = _timed(torch, lambda: [e._create_model(fit(inputs, dict(e._tpu_params))) for e in ests])
    finally:
        st.WIRE_DTYPE = saved
    return models, t, st.last_ingest_report()


def wire_report(rep):
    """What a fit's ingest report says of its wire: the resolved encoding,
    the bytes sent, the host seconds of encoding and of copies into the
    ring, the card's copy-stream seconds and the seconds a pass."""
    chunked = [k for k in rep["passes"] if k not in ("labels", "seed_rows")]  # not host passes
    return {"wire_dtype": rep.get("wire_dtype"), "bytes": rep["bytes"], "chunks": rep["chunks"],
            "encode_s": rep["encode_s"], "host_to_pinned_s": rep.get("host_to_pinned_s"),
            "host_to_device_s": rep.get("host_to_device_s"), "fold_device_s": rep.get("fold_device_s"),
            "decode_s": rep.get("decode_s"), "passes": rep["passes"],
            "pass_s": sum(rep["pass_s"][k] for k in chunked) / sum(rep["passes"][k] for k in chunked)}


def wire_chunk_hold(torch, st, chunk, Xd, wire):
    """One host chunk through ``put_chunk`` at ``wire`` onto the card,
    each entry of the dequantized ``X`` held against the f32 rows ``Xd``:
    f16 within half an f16 ulp (2⁻¹¹·|x| + 2⁻²⁵); int8 within half its
    column's step s plus the f32 roundings of the host quotient and the
    card's multiply and add, s/2 + 4u·(|offset| + 128·s); e4m3 within half
    an ulp of 3 mantissa bits, 2⁻⁴·|x| + 2⁻¹⁰·s (subnormals), plus 4u·|x|
    (f32's). Returns the largest |error| / tolerance and the bytes sent."""
    dev = st.put_chunk(chunk, Xd.device, wire=wire)
    torch.cuda.current_stream().wait_event(dev["_ready"])
    err = (dev["X"] - Xd).abs()
    x = Xd.abs()
    lo, hi = Xd.amin(dim=0), Xd.amax(dim=0)
    if wire == "f16":
        tol = 2.0 ** -11 * x + 2.0 ** -25
    elif wire == "int8":
        s = torch.where(hi > lo, (hi - lo) / 254.0, torch.ones_like(hi))
        tol = (0.5 * s + 4.0 * U32 * ((hi + lo).abs() * 0.5 + 128.0 * s))[None, :].expand_as(x)
    else:
        amax = torch.maximum(hi.abs(), lo.abs())
        s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        tol = 2.0 ** -4 * x + 2.0 ** -10 * s[None, :] + 4.0 * U32 * x
    return float((err / tol).max()), dev["_bytes"]


def phase_stream_wire(torch, X_host, lin, seed):
    """(o) The wire formats: the first STREAM_WIRE_ROWS host rows as a
    generator of 12 chunks. First one chunk through ``put_chunk`` at f16,
    int8 and f8, held entry by entry (``wire_chunk_hold``), and int8 again
    with the card's dequantize given an offset two steps off, which the
    hold must refuse. Then streamed PCA(k=16) at each of WIRE_KINDS (the
    f32 fit held to the f64 truth of the rows; each other against it at
    the JAX package's wire tolerances), the three-config LinearRegression
    ``fitMultiple`` at f32 (OLS held to its f64 solve) and f16 (against
    f32), and KMeans(k=1024, random init, maxIter 2) at f32 and int8 (the
    same seeds; int8 against f32). Each fit: its K1 or K2 launches one a
    chunk of each Gram, Lloyd and cost pass, none of K2's plain version;
    its wire's bytes, encode and host-copy seconds and seconds a pass.
    Returns the K1 launches and the K2 launches {row: {path: n}}."""
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.data.chunks import Chunk
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import linalg as lin_ops
    from spark_rapids_ml_tpu_torch.ops import streaming as st
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    N, CH = min(STREAM_WIRE_ROWS, X_host.shape[0]), STREAM_CHUNK_ROWS
    n_chunks = -(-N // CH)
    # one chunk, entry by entry, and the perturbed-offset control
    first = np.ascontiguousarray(X_host[:CH])
    chunk = Chunk(X=first, n_valid=first.shape[0])
    Xd = torch.from_numpy(first).to(dev)
    holds = {w: wire_chunk_hold(torch, st, chunk, Xd, w) for w in ("f16", "int8", "f8")}
    real = st._dequantize
    st._dequantize = lambda q, s, o, w, dt: real(q, s, None if o is None else o + 2.0 * s.to(dt), w, dt)
    try:
        control = wire_chunk_hold(torch, st, chunk, Xd, "int8")[0]
    finally:
        st._dequantize = real
    del Xd
    emit({"phase": "streamed", "check": "wire_chunk", "rows": first.shape[0], "f32_bytes": first.nbytes,
          "err_over_tol": {w: r for w, (r, _) in holds.items()}, "bytes": {w: b for w, (_, b) in holds.items()},
          "perturbed_offset_control_err_over_tol": control})
    for w, (r, _) in holds.items():
        check(r <= 1.0, f"the {w} wire's chunk is {r:.3g} x its tolerance off the f32 rows")
    check(control > 1.0, f"the int8 hold did not refuse an offset two steps off ({control:.3g})")

    # the f64 truths of the rows, at the band of a pass of n_chunks chunks
    # (each chunk's sums within K1's band, then an f32 sum of the partials)
    y = np.ascontiguousarray(lin["y"][:N])
    Xd, yd = torch.from_numpy(X_host[:N]).to(dev), torch.from_numpy(y).to(dev)
    sums = f64_sums(torch, [(Xd[lo:lo + CH], 1) for lo in range(0, N, CH)],
                    [(yd[lo:lo + CH], 1) for lo in range(0, N, CH)])
    terms, walk = TOL_TERMS + n_chunks, TOL_WALK * CH ** 0.5
    truth = pca_truth(torch, sums, STREAM_K, terms, walk)
    ols = ols_solve_reference_band(torch, sums, terms, walk)
    mx = sums["mx"].cpu().numpy()
    del Xd, yd, sums
    torch.cuda.empty_cache()
    src, src_y = wire_source(X_host, None, N), wire_source(X_host, y, N)

    rows, pca = {}, {}
    k1 = 0
    for w in WIRE_KINDS:
        l0 = lin_ops.shifted_gram.launches
        (m,), t, rep = stream_fit(torch, st, [PCA(k=STREAM_K)], src, N, w)
        k = lin_ops.shifted_gram.launches - l0
        k1 += k
        pca[w] = m
        row = {"fit_s": t, "shifted_gram_launches": k, **wire_report(rep)}
        check(rep["passes"] == {"moments": 1, "gram": 1} and k == n_chunks,
              f"PCA at {w}: passes {rep['passes']}, {k} K1 launches (want {n_chunks})")
        resolved = rep.get("wire_dtype")
        check(resolved in WIRE_KINDS[:4] and (w == "auto" or resolved == w),
              f"PCA at {w}: the passes shipped {resolved}")
        if w == "f32":
            row["vs_f64"] = check_pca_fit(torch, m, truth, "PCA at f32")
        else:
            row["vs_f32"] = pca_wire_errors(pca["f32"], m, resolved)
            check(all(v <= 1.0 for v in row["vs_f32"]["over_tol"].values()),
                  f"PCA at {w} ({resolved}) off the f32 fit: {row['vs_f32']}")
        rows[w] = row
    emit({"phase": "streamed", "check": "wire_pca", "rows": N, "k": STREAM_K, "chunks": n_chunks, "fits": rows})

    grid = [c for _, c in LINREG_CONFIGS]
    lr_rows, lr = {}, {}
    for w in ("f32", "f16"):
        l0 = lin_ops.shifted_gram.launches
        lr[w], t, rep = stream_fit(torch, st, [LinearRegression()._with_params(c) for c in grid], src_y, N, w)
        k = lin_ops.shifted_gram.launches - l0
        k1 += k
        lr_rows[w] = {"fit_multiple_s": t, "shifted_gram_launches": k, **wire_report(rep)}
        check(rep["passes"] == {"moments": 1, "gram": 1} and k == n_chunks and rep.get("wire_dtype") == w,
              f"LinearRegression fitMultiple at {w}: passes {rep['passes']}, {k} K1 launches, "
              f"wire {rep.get('wire_dtype')}")
    e_ref = scaled_errors(lr["f32"][0], ols["beta"], ols["intercept"], ols["std"], mx)
    err_b = abs(float(lr["f32"][0].intercept) - ols["intercept"])
    lr_rows["f32"]["ols_vs_f64"] = {"coef_scaled_rel_err": e_ref[0], "coef_tol": ols["coef_tol"],
                                    "intercept_abs_err": err_b, "intercept_tol": ols["intercept_tol"]}
    check(e_ref[0] <= ols["coef_tol"] and err_b <= ols["intercept_tol"],
          f"OLS at f32 off its f64 solve: {lr_rows['f32']['ols_vs_f64']}")
    diffs = {name: {"coef_max_abs_diff": float(np.abs(np.asarray(a.coefficients, np.float64) - b.coefficients).max()),
                    "intercept_abs_diff": abs(float(a.intercept) - float(b.intercept))}
             for (name, _), a, b in zip(LINREG_CONFIGS, lr["f16"], lr["f32"])}
    lr_rows["f16"]["vs_f32"] = {"configs": diffs, "atol": WIRE_LINREG_ATOL}
    emit({"phase": "streamed", "check": "wire_linreg", "rows": N, "fits": lr_rows})
    for name, dd in diffs.items():
        check(np.isfinite(dd["coef_max_abs_diff"]) and max(dd.values()) <= WIRE_LINREG_ATOL,
              f"LinearRegression {name} at f16 off the f32 fit: {dd}")

    km, km_rows, k2 = {}, {}, 0
    for w in ("f32", "int8"):
        with record_kmeans_fit(kk) as rec:
            (km[w],), t, rep = stream_fit(torch, st, [KMeans(k=E2E_CENTRES, seed=seed, initMode="random",
                                                             maxIter=STREAM_KM_ITER)], src, N, w)
        k2 += rec["launches"]
        km[w + "_seeds"] = rec["centers0"]
        km_rows[w] = {"fit_s": t, "n_iter": km[w].numIter, "cost": km[w].trainingCost,
                      "lloyd_step_launches": rec["launches"], **wire_report(rep)}
        check(rep.get("wire_dtype") == w and rec["plain_calls"] == 0
              and rec["launches"] == n_chunks * (rep["passes"].get("lloyd", 0) + rep["passes"].get("cost", 0))
              and rep["passes"].get("lloyd") == km[w].numIter,
              f"KMeans at {w}: passes {rep['passes']}, {rec['launches']} K2 launches, "
              f"{rec['plain_calls']} plain calls, wire {rep.get('wire_dtype')}")
    c8, c32 = km["int8"].cluster_centers_.astype(np.float64), km["f32"].cluster_centers_.astype(np.float64)
    counts = centre_counts(torch, X_host[:N], c32)
    d2 = ((c8 - c32) ** 2).mean(axis=1)
    rms = float(np.sqrt((counts * d2).sum() / counts.sum()))
    worst = int(np.argmax(d2))
    dcost = abs(km["int8"].trainingCost - km["f32"].trainingCost) / km["f32"].trainingCost
    km_rows["int8"]["vs_f32"] = {"centre_rms_diff_by_rows": rms, "atol": WIRE_KM_ATOL, "cost_rel_diff": dcost,
                                 "cost_rtol": WIRE_STAT_TOL["int8"],
                                 "centre_max_abs_diff": float(np.abs(c8 - c32).max()),
                                 "rows_of_the_centre_furthest_apart": int(counts[worst]),
                                 "mean_rows_a_centre": N / E2E_CENTRES}
    emit({"phase": "streamed", "check": "wire_kmeans", "rows": N, "k": E2E_CENTRES, "maxIter": STREAM_KM_ITER,
          "fits": km_rows})
    check(np.array_equal(km["f32_seeds"], km["int8_seeds"]), "KMeans at f32 and int8: the random seeds differ")
    check(rms <= WIRE_KM_ATOL and dcost <= WIRE_STAT_TOL["int8"],
          f"KMeans at int8 off the f32 fit: {km_rows['int8']['vs_f32']}")
    emit({"phase": "streamed", "check": "wire_done", "s": time.perf_counter() - t0, "shifted_gram_launches": k1,
          "lloyd_step_launches": k2})
    return k1, {f"lloyd_step_stream_k{E2E_CENTRES}": {"stream_wire": k2}}


def centre_counts(torch, X_host, C):
    """The rows of ``X_host`` nearest each centre of ``C`` (f64 scores on
    the card, in chunks)."""
    dev = torch.device("cuda:0")
    Cd = torch.from_numpy(C).to(dev)
    c_sq = (Cd * Cd).sum(dim=1)
    counts = torch.zeros(C.shape[0], dtype=torch.int64, device=dev)
    for lo in range(0, X_host.shape[0], STREAM_CHUNK_ROWS):
        x = torch.from_numpy(X_host[lo:lo + STREAM_CHUNK_ROWS]).to(dev, torch.float64)
        counts += torch.bincount(torch.argmin(c_sq[None, :] - 2.0 * (x @ Cd.T), dim=1), minlength=C.shape[0])
    return counts.cpu().numpy().astype(np.float64)


def pca_wire_errors(ref, m, wire):
    """A PCA fit at ``wire`` against the f32 fit ``ref``: its mean (over
    the largest |mean|) and explained variance (relative) within the
    wire's statistics tolerance, the variances at WIRE_EV_RTOL, each
    component's |cosine| with its f32 counterpart within WIRE_COS_TOL of
    1. Returns the errors and each over its tolerance."""
    mean_err = float(np.abs(m.mean_ - ref.mean_).max() / np.abs(ref.mean_).max())
    ev_err = float((np.abs(m.explained_variance_ - ref.explained_variance_) / ref.explained_variance_).max())
    a, b = np.asarray(m.components_, np.float64), np.asarray(ref.components_, np.float64)
    cos = np.abs((a * b).sum(axis=1)) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    cos_err = float((1.0 - cos).max())
    return {"wire": wire, "mean_rel_err": mean_err, "ev_rel_err": ev_err, "cos_err": cos_err,
            "over_tol": {"mean": mean_err / WIRE_STAT_TOL[wire], "ev": ev_err / WIRE_EV_RTOL[wire],
                         "cos": cos_err / WIRE_COS_TOL}}


def phase_stream_resume(torch, X_host, y_host, seed):
    """(p) Checkpoint/resume, on the wire phase's rows with
    ``runtime.checkpoint.CKPT_DIR`` a temporary directory:
    LogisticRegression(maxIter=RESUME_LR_ITER) and KMeans(k=1024, random
    init, tol 1e-20, maxIter=RESUME_KM_ITER), each fitted uninterrupted
    (no checkpoints), interrupted by ``interrupting_source`` in the first
    pass after the checkpoint of iteration RESUME_AFTER, and fitted again.
    The resumed fit must start at the committed iteration (its objective or
    Lloyd passes fewer by those the interrupted fit completed), leave no
    file behind, and equal the uninterrupted fit: LogisticRegression bit
    for bit (K3 adds no atomics, every pass repeats itself); KMeans within
    two streamed walks' band from one f64 iteration compounded over the
    iterations (K2 adds with atomics: bitwise equality reported). Returns
    the K3 and K2 launches {row: {path: n}}."""
    import shutil
    import tempfile

    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk
    from spark_rapids_ml_tpu_torch.ops import streaming as st
    from spark_rapids_ml_tpu_torch.runtime import checkpoint as ckpt

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    N, CH = min(STREAM_WIRE_ROWS, X_host.shape[0]), STREAM_CHUNK_ROWS
    n_chunks = -(-N // CH)
    y = np.ascontiguousarray(y_host[:N])
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saved = ckpt.CKPT_DIR
    k3 = k2 = 0
    try:
        # LogisticRegression
        def lr_fit(source):
            return stream_fit(torch, st, [LogisticRegression(maxIter=RESUME_LR_ITER)], source, N)

        l0 = lk.logreg_loss_grad.launches
        (full,), t_full, rep_full = lr_fit(wire_source(X_host, y, N))
        ckpt.CKPT_DIR = ckpt_dir
        t = time.perf_counter()
        try:
            lr_fit(interrupting_source(X_host, y, N, ckpt_dir))
            interrupted = False
        except ResumeInterrupt:
            interrupted = True
        t_int = time.perf_counter() - t
        torch.cuda.synchronize()
        done = st.last_ingest_report()["passes"].get("objective", 1) - 1
        at = committed_iteration(ckpt_dir)
        (res,), t_res, rep = lr_fit(wire_source(X_host, y, N))
        ckpt.CKPT_DIR = saved
        k3 = lk.logreg_loss_grad.launches - l0
        left = os.listdir(ckpt_dir)
        same = (res.coefficientMatrix.tobytes() == full.coefficientMatrix.tobytes()
                and res.interceptVector.tobytes() == full.interceptVector.tobytes())
        lr_row = {"interrupted": interrupted, "committed_iteration": at, "objective_passes_done": done,
                  "passes": [rep_full["passes"], rep["passes"]], "fit_s": [t_full, t_int, t_res],
                  "n_iter": [full.n_iter_, res.n_iter_], "bit_for_bit": same, "files_left": left,
                  "coef_max_abs_diff": float(np.abs(res.coefficientMatrix - full.coefficientMatrix).max()),
                  "logreg_loss_grad_launches": k3}
        emit({"phase": "streamed", "check": "resume_logreg", "rows": N, "maxIter": RESUME_LR_ITER, **lr_row})
        check(interrupted and at == RESUME_AFTER, f"LogisticRegression resume: interrupted {interrupted} "
                                                  f"after the checkpoint of iteration {at}")
        check(rep["passes"]["objective"] == rep_full["passes"]["objective"] - done and done > 0,
              f"resumed LogisticRegression: {rep['passes']} against {rep_full['passes']}, {done} passes done")
        check(same and res.n_iter_ == full.n_iter_ and not left,
              f"resumed LogisticRegression differs from the uninterrupted fit or left {left}")

        # KMeans
        def km_fit_at(source):
            with record_kmeans_fit(kk) as rec:
                (m,), t, rep = stream_fit(torch, st, [KMeans(k=E2E_CENTRES, seed=seed, initMode="random",
                                                             tol=STREAM_KM_TOL, maxIter=RESUME_KM_ITER)], source, N)
            return m, t, rep, rec

        ckpt.CKPT_DIR = None
        full, t_full, rep_full, rec_full = km_fit_at(wire_source(X_host, None, N))
        k2 += rec_full["launches"]
        ckpt.CKPT_DIR = ckpt_dir
        t = time.perf_counter()
        try:
            with record_kmeans_fit(kk) as rec_int:
                stream_fit(torch, st, [KMeans(k=E2E_CENTRES, seed=seed, initMode="random", tol=STREAM_KM_TOL,
                                              maxIter=RESUME_KM_ITER)], interrupting_source(X_host, None, N, ckpt_dir),
                           N)
            interrupted = False
        except ResumeInterrupt:
            interrupted = True
        t_int = time.perf_counter() - t
        torch.cuda.synchronize()
        k2 += rec_int["launches"]
        done = st.last_ingest_report()["passes"].get("lloyd", 1) - 1
        at = committed_iteration(ckpt_dir)
        res, t_res, rep, rec = km_fit_at(wire_source(X_host, None, N))
        ckpt.CKPT_DIR = saved
        k2 += rec["launches"]
        left = os.listdir(ckpt_dir)
        C0 = rec["centers0"]
        Xd = torch.from_numpy(X_host[:N]).to(dev)
        ref = lloyd_reference(torch, kk, Xd, torch.ones(N, device=dev), torch.from_numpy(C0).to(dev), chunk=CH)
        del Xd
        torch.cuda.empty_cache()
        _, e_s, _ = km_centre_bands(torch, ref, torch.from_numpy(C0).to(dev), N, CH, n_chunks)
        iters = RESUME_KM_ITER
        band = 2.0 * float(torch.nan_to_num(e_s, nan=0.0).max()) * iters
        cost_pass = U32 * ((2.0 * TOL_TERMS + 2.0 * n_chunks) * float(ref["T_cost"])
                           + 2.0 * TOL_WALK * CH ** 0.5 * float(ref["cost"])) + 2.0 * float(ref["slack_cost"])
        dc = np.abs(res.cluster_centers_.astype(np.float64) - full.cluster_centers_).max(axis=1)
        d_cost = abs(res.trainingCost - full.trainingCost)
        km_row = {"interrupted": interrupted, "committed_iteration": at, "lloyd_passes_done": done,
                  "passes": [rep_full["passes"], rep["passes"]], "fit_s": [t_full, t_int, t_res],
                  "n_iter": [full.numIter, res.numIter], "bit_for_bit": res.cluster_centers_.tobytes() == (
                      full.cluster_centers_.tobytes()), "files_left": left, "centre_max_abs_diff": float(dc.max()),
                  "centre_band": band, "centres_beyond_band": int((dc > band).sum()), "cost_abs_diff": d_cost,
                  "cost_tol": (iters + 1) * cost_pass, "seeds_equal": np.array_equal(C0, rec_full["centers0"]),
                  "lloyd_step_launches": k2}
        emit({"phase": "streamed", "check": "resume_kmeans", "rows": N, "k": E2E_CENTRES, "maxIter": RESUME_KM_ITER,
              **km_row})
        check(interrupted and at == RESUME_AFTER and done == RESUME_AFTER,
              f"KMeans resume: interrupted {interrupted} after the checkpoint of iteration {at}, {done} passes done")
        check(rep["passes"].get("lloyd") == rep_full["passes"]["lloyd"] - done and rep["passes"].get("cost") == 1,
              f"resumed KMeans: {rep['passes']} against {rep_full['passes']}")
        check(km_row["seeds_equal"] and res.numIter == full.numIter and not left and rec["plain_calls"] == 0,
              f"resumed KMeans: seeds, iterations or files differ: {km_row}")
        check(km_row["centres_beyond_band"] == 0 and d_cost <= km_row["cost_tol"],
              f"resumed KMeans off the uninterrupted fit: {km_row}")
    finally:
        ckpt.CKPT_DIR = saved
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "streamed", "check": "resume_done", "s": time.perf_counter() - t0})
    return {"logreg_loss_grad_stream_rows": {"stream_resume": k3},
            f"lloyd_step_stream_k{E2E_CENTRES}": {"stream_resume": k2}}


def phase_streamed(torch, X_host, y_host, lin, pca_ref, seed, km_resident=None):
    """The streamed phase: (a) the copy, (c) streamed vs resident fits,
    (d) the north star, (e) the parquet scan, then the streamed
    LogisticRegression (f-k, ``phase_stream_logreg``) and the streamed
    KMeans (l-n, ``phase_stream_kmeans``; ``km_resident``: the e2e phase's
    k-means|| model and its fit seconds, where it ran). Returns the K1
    launches of its fits, counted alone, K1's measurement at the chunk
    shape, K3's and K2's at their chunk shapes and K3's and K2's launches
    by kernels-line row and path."""
    t = time.perf_counter()
    phase_stream_copy(torch, X_host)
    launches = phase_stream_vs_resident(torch, X_host, lin, pca_ref)
    k, k1 = phase_north_star(torch, seed)
    launches += k + (phase_stream_parquet(torch, X_host) or 0)
    k3, k3_launches = phase_stream_logreg(torch, X_host, y_host, seed)
    k2, k2_launches = phase_stream_kmeans(torch, X_host, seed, km_resident)
    k, wire_k2 = phase_stream_wire(torch, X_host, lin, seed)
    launches += k
    for row, paths in list(wire_k2.items()) + list(phase_stream_resume(torch, X_host, y_host, seed).items()):
        (k3_launches if row.startswith("logreg") else k2_launches).setdefault(row, {}).update(paths)
    emit({"phase": "streamed", "check": "done", "s": time.perf_counter() - t, "shifted_gram_launches": launches,
          "logreg_loss_grad_launches": k3_launches, "lloyd_step_launches": k2_launches})
    return launches, k1, k3, k3_launches, k2, k2_launches


def stream_probe(torch, args, dev) -> int:
    """The streamed phase alone on ``--rows`` rows made from ``--seed``."""
    from spark_rapids_ml_tpu_torch.feature import PCA

    t0 = time.perf_counter()
    n = args.rows
    csize = PCA._equal_chunk_rows(n, 1, 65_536)
    X, y = make_data(torch, n, -(-n // csize) * csize, args.seed, dev)
    lin = linreg_data(torch, X[:n], args.seed, paths=("linreg",))["linreg"]
    pca_ref = pca_reference(torch, X[:n])
    X_host, y_host = X[:n].cpu().numpy(), y.cpu().numpy()
    del X, y
    torch.cuda.empty_cache()
    launches, _, _, k3_launches, _, k2_launches = phase_streamed(torch, X_host, y_host, lin, pca_ref, args.seed)
    emit({"phase": "done", "total_s": time.perf_counter() - t0, "shifted_gram_launches": launches,
          "logreg_loss_grad_launches": k3_launches, "lloyd_step_launches": k2_launches})
    return 0


def wire_probe(torch, args, dev) -> int:
    """The wire and resume phases alone, on min(``--rows``,
    STREAM_WIRE_ROWS) rows made from ``--seed``."""
    t0 = time.perf_counter()
    n = min(args.rows, STREAM_WIRE_ROWS)
    X, y = make_data(torch, n, n, args.seed, dev)
    lin = linreg_data(torch, X, args.seed, paths=("linreg",))["linreg"]
    X_host, y_host = X.cpu().numpy(), y.cpu().numpy()
    del X, y
    torch.cuda.empty_cache()
    k1, launches = phase_stream_wire(torch, X_host, lin, args.seed)
    for row, paths in phase_stream_resume(torch, X_host, y_host, args.seed).items():
        launches.setdefault(row, {}).update(paths)
    emit({"phase": "done", "total_s": time.perf_counter() - t0, "shifted_gram_launches": k1, "launches": launches})
    return 0


# ---------------------------------------------------------------------------
# float64 inputs: the main path's fits at float32_inputs=False
# ---------------------------------------------------------------------------

# the first rows of the 12M (the wire phase's count), in f64: 3.2 GB at the
# main path's width
F64_ROWS = 1_572_864
F64_K = 16
F64_KM_K = 1024
F64_KM_ITER = 5
F64_LR_ITER = 20
F64_STREAM_LR_ITER = 5
# a penalty that keeps the phase's labels' fit bounded
F64_LR_REG = 1e-3
# the JAX package's f64 LogisticRegression tests hold coefficients at atol 1e-4
F64_LR_ATOL = 1e-4
F64_KM_AGREE_MIN = 0.999
U64 = 2.0 ** -53


def f64_labels(torch, X, seed):
    """Binomial labels no hyperplane separates (the e2e labels are a
    hyperplane's): p = sigmoid(2·(z - median z) / std z) for z = X·w, w ~
    N(0, 1) and the draws from numpy's ``seed`` (the product on the card in
    f64). Returns host f64 labels."""
    rng = np.random.default_rng(seed + 26)
    w = torch.from_numpy(rng.normal(size=X.shape[1])).to(X.device)
    z = X.to(torch.float64) @ w
    z = 2.0 * (z - z.median()) / z.std()
    p = torch.sigmoid(z).cpu().numpy()
    return (rng.random(p.shape[0]) < p).astype(np.float64)


class LrObjective64:
    """The binomial LogisticRegression objective in f64 on the card, the
    phase's own (no port code): the mean log-loss of the logits X·(a·s) + b
    - (a·s)·μ in the solver's standardized coordinates (s = 1/std, the
    unbiased std; μ the mean), plus l2/2·‖a‖²; value and gradient in closed
    form, for ``minimize_lbfgs_host``."""

    def __init__(self, torch, X, y, l2):
        self.torch, self.X, self.y, self.l2 = torch, X, y, l2
        self.n, self.d = X.shape
        self.mean = X.mean(dim=0)
        std = ((X - self.mean) ** 2).sum(dim=0).div(self.n - 1).sqrt()
        self.inv_std = torch.where(std > 0, 1.0 / std, torch.ones_like(std))
        self.std = std

    def effective(self, w):
        w = self.torch.from_numpy(np.asarray(w, np.float64)).to(self.X.device)
        A = w[:self.d] * self.inv_std
        return w, A, w[self.d] - A @ self.mean

    def __call__(self, w_np):
        torch = self.torch
        w, A, b = self.effective(w_np)
        z = self.X @ A + b
        f = float((torch.nn.functional.softplus(z) - self.y * z).mean()) + 0.5 * self.l2 * float(w[:self.d] @ w[:self.d])
        r = torch.sigmoid(z) - self.y
        gb = r.mean()
        gA = ((self.X.T @ r) / self.n - gb * self.mean) * self.inv_std + self.l2 * w[:self.d]
        return f, torch.cat([gA, gb[None]]).cpu().numpy()

    def objective_of(self, coef, intercept):
        """The f64 objective of a fitted model's (coef, intercept) in
        original coordinates, its penalty on coef·std."""
        torch = self.torch
        a = torch.from_numpy(np.asarray(coef, np.float64).reshape(-1)).to(self.X.device)
        z = self.X @ a + float(np.asarray(intercept).reshape(-1)[0])
        return float((torch.nn.functional.softplus(z) - self.y * z).mean()) + 0.5 * self.l2 * float(
            ((a * self.std) ** 2).sum())


@contextlib.contextmanager
def launch_counts(wrappers):
    """While open: the launches of each (module, wrapper, plain version)
    triple's wrapper and the calls of its plain version (none may come on
    the card), read as ``rec()``."""
    plain = {p: 0 for _, _, p in wrappers}
    reals = {(mod, p): getattr(mod, p) for mod, _, p in wrappers}
    for (mod, name), real in reals.items():
        def spy(*a, _name=name, _real=real, **kw):
            plain[_name] += 1
            return _real(*a, **kw)
        setattr(mod, name, spy)
    k0 = {w: getattr(mod, w).launches for mod, w, _ in wrappers}
    try:
        yield lambda: {**{w: getattr(mod, w).launches - k0[w] for mod, w, _ in wrappers}, **plain}
    finally:
        for (mod, name), real in reals.items():
            setattr(mod, name, real)


def kernel_counts(lin, kk, lk):
    """``launch_counts`` of K1, K2 and K3."""
    return launch_counts(((lin, "shifted_gram", "shifted_gram_plain"), (kk, "lloyd_step", "lloyd_step_plain"),
                          (lk, "logreg_loss_grad", "logreg_loss_grad_plain")))


def phase_f64(torch, X_host, seed):
    """(q) float64 inputs (``float32_inputs=False``) on the first F64_ROWS of
    the host rows in f64 (3.2 GB at d = 256): PCA(k=16), the three-config
    LinearRegression ``fitMultiple``, binomial LogisticRegression(maxIter
    20), KMeans(k=1024, random, maxIter 5), streamed PCA(k=16) and streamed
    LogisticRegression(maxIter 5) at 131,072-row chunks, each beside the same
    fit at f32 on the same rows, and the four transforms. Truths on the card
    in f64, outside the port: the covariance as one Xcᵀ·Xc product with
    ``eigh``, OLS from the normal equations, an f64 L-BFGS
    (``minimize_lbfgs_host``) of the phase's own objective. Holds: f64 PCA and
    OLS within the f64 ``held`` band (u = 2⁻⁵³) of their truths, the f32 fits
    outside it; streamed f64 PCA within 8·√n·u of the resident f64 fit, entry
    by entry, the streamed LogisticRegression's f64 objective within 8·√n·u
    of the resident's (its coefficients reported); LogisticRegression within
    F64_LR_ATOL of its truth; KMeans f64 against f32 on >= F64_KM_AGREE_MIN
    of the predictions, costs within the f32 band; every f64 transform in
    f64. The f64 fits launch no K1, K2 or K3 and call no plain version, the
    f32 fits launch each; a kernel wrapper given an f64 card tensor raises.
    Returns the f32 fits' launches {kernels-line row: {path: n}}."""
    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk
    from spark_rapids_ml_tpu_torch.ops.lbfgs import minimize_lbfgs_host
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    n = min(F64_ROWS, X_host.shape[0])
    X32 = np.ascontiguousarray(X_host[:n])
    X64 = X32.astype(np.float64)
    band = 8.0 * n ** 0.5 * U64

    # the wrappers refuse an f64 card tensor: there is no fallback on the card
    x, m = torch.ones((64, 8), dtype=torch.float64, device=dev), torch.ones(64, dtype=torch.float64, device=dev)
    refusals = {}
    for name, call in (("shifted_gram", lambda: lin.shifted_gram(x, m, x[0])),
                       ("lloyd_step", lambda: kk.lloyd_step(x, m, x[:4])),
                       ("logreg_loss_grad", lambda: lk.logreg_loss_grad(x, m, m, x[:1], m[:1], False))):
        try:
            call()
            refusals[name] = "accepted"
        except NotImplementedError as e:
            refusals[name] = str(e)
    emit({"phase": "f64", "check": "wrappers_refuse_f64", "refusals": refusals})
    check(all(v != "accepted" for v in refusals.values()), f"a kernel wrapper took an f64 tensor: {refusals}")
    del x, m

    # labels and truths, on the card in f64
    Xd = torch.from_numpy(X64).to(dev)
    y_lr = f64_labels(torch, Xd, seed)
    y_ols, _ = linreg_labels(torch, torch.from_numpy(X32).to(dev), seed + 27)
    t = time.perf_counter()
    pca64 = pca_truth(torch, f64_sums(torch, [(Xd, 1)]), F64_K, TOL_TERMS, TOL_WALK * n ** 0.5, u=U64)
    ols64 = ols_reference(torch, Xd, y_ols.astype(np.float64), u=U64)
    obj = LrObjective64(torch, Xd, torch.from_numpy(y_lr).to(dev), F64_LR_REG)
    ref = minimize_lbfgs_host(obj, np.zeros(X64.shape[1] + 1), max_iter=F64_LR_ITER, tol=1e-6)
    _, ref_A, ref_b = obj.effective(ref.w)
    ref_coef, ref_b = ref_A.cpu().numpy(), float(ref_b)
    truth_s = time.perf_counter() - t
    emit({"phase": "f64", "check": "truths", "rows": n, "d": X64.shape[1], "s": truth_s,
          "pca_gap": pca64["gap"], "pca_sin_tol": pca64["sin_tol"], "ols_kappa": ols64["kappa"],
          "ols_coef_tol": ols64["coef_tol"], "ols_intercept_tol": ols64["intercept_tol"],
          "lr_reference_n_iter": ref.n_iter, "lr_reference_objective": ref.f, "labels_mean": float(y_lr.mean())})

    frames = {dt: (DataFrame({"features": X, "label": y_lr.astype(dt)}),
                   DataFrame({"features": X, "label": y_ols.astype(dt)}))
              for dt, X in ((np.float64, X64), (np.float32, X32))}
    chunk = STREAM_CHUNK_ROWS
    fits = (("pca", "shifted_gram", lambda f32, df, _: PCA(k=F64_K, float32_inputs=f32).fit(df)),
            ("linreg_fitMultiple", "shifted_gram", lambda f32, _, df: [m for _, m in sorted(
                LinearRegression(float32_inputs=f32).fitMultiple(df, [kw for _, kw in LINREG_CONFIGS]),
                key=lambda t: t[0])]),
            ("logreg", "logreg_loss_grad", lambda f32, df, _: LogisticRegression(
                maxIter=F64_LR_ITER, regParam=F64_LR_REG, float32_inputs=f32).fit(df)),
            ("kmeans", "lloyd_step", lambda f32, df, _: KMeans(
                k=F64_KM_K, initMode="random", maxIter=F64_KM_ITER, seed=seed, float32_inputs=f32).fit(df)),
            ("pca_streamed", "shifted_gram", lambda f32, df, _: PCA(
                k=F64_K, streaming=True, stream_chunk_rows=chunk, float32_inputs=f32).fit(df)),
            ("logreg_streamed", "logreg_loss_grad", lambda f32, df, _: LogisticRegression(
                maxIter=F64_STREAM_LR_ITER, regParam=F64_LR_REG, streaming=True, stream_chunk_rows=chunk,
                float32_inputs=f32).fit(df)),
            ("logreg_5", "logreg_loss_grad", lambda f32, df, _: LogisticRegression(
                maxIter=F64_STREAM_LR_ITER, regParam=F64_LR_REG, float32_inputs=f32).fit(df)))
    models = {}
    launches = {"shifted_gram": {}, "lloyd_step": {}, "logreg_loss_grad": {}, "logreg_loss_grad_stream_rows": {}}
    for name, kernel, fit in fits:
        row = {"phase": "f64", "fit": name}
        for dt in (np.float64, np.float32):
            if name == "logreg_5" and dt == np.float32:
                continue  # the streamed fit's resident twin, at f64 only
            tag = "f64" if dt == np.float64 else "f32"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            with kernel_counts(lin, kk, lk) as counts:
                model, s = _timed(torch, lambda: fit(dt == np.float32, *frames[dt]))
                c = counts()
            models[name, tag] = model
            row[tag] = {"fit_s": s, "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "counts": c}
            if tag == "f64":
                check(all(v == 0 for v in c.values()), f"f64 {name}: a kernel or its plain version ran: {c}")
            else:
                check(c[kernel] > 0 and not any(v for k, v in c.items() if k.endswith("_plain")),
                      f"f32 {name}: {kernel} not launched, or a plain version ran: {c}")
                k_row = "logreg_loss_grad_stream_rows" if name == "logreg_streamed" else kernel
                launches[k_row]["f64_phase_f32"] = launches[k_row].get("f64_phase_f32", 0) + c[kernel]
        emit(row)

    # the transforms of the f64 models, each in f64 (KMeans: int32, as in the JAX package)
    df64_lr, df64_ols = frames[np.float64]
    tr = {}
    for name, model, df, col, want in (("pca", models["pca", "f64"], df64_lr, "pca_features", np.float64),
                                       ("linreg", models["linreg_fitMultiple", "f64"][0], df64_ols, "prediction",
                                        np.float64),
                                       ("logreg", models["logreg", "f64"], df64_lr, "probability", np.float64),
                                       ("kmeans", models["kmeans", "f64"], df64_lr, "prediction", np.int32)):
        with kernel_counts(lin, kk, lk) as counts:
            out, s = _timed(torch, lambda: model.transform(df))
            c = counts()
        v = out.column(col)
        tr[name] = {"s": s, "dtype": str(v.dtype), "shape": list(v.shape)}
        check(v.dtype == want and v.shape[0] == n and np.isfinite(v).all() and not any(c.values()),
              f"f64 {name} transform: {v.dtype} (want {np.dtype(want)}), {v.shape}, {c}")
        if name == "kmeans":
            pred64 = v
        del out, v
    pred32 = models["kmeans", "f32"].transform(frames[np.float32][0]).column("prediction")
    emit({"phase": "f64", "check": "transforms", "transforms": tr})

    # PCA and OLS against their f64 truths; the f32 fits must fail the band
    holds = {}
    for tag in ("f64", "f32"):
        ev_err, sin, mean_ratio = pca_errors(torch, models["pca", tag], pca64)
        ok = ev_err <= pca64["ev_tol"] and sin <= pca64["sin_tol"] and mean_ratio <= 1.0
        holds[f"pca_{tag}"] = {"ev_err_over_tol": ev_err / pca64["ev_tol"], "sin_over_tol": sin / pca64["sin_tol"],
                               "mean_err_over_tol": mean_ratio, "held": ok}
        ols = models["linreg_fitMultiple", tag][0]
        dev_s = ols64["std"] * (np.asarray(ols.coefficients, np.float64) - ols64["beta"])
        err = float(np.linalg.norm(dev_s) / np.linalg.norm(ols64["std"] * ols64["beta"]))
        err_b = abs(float(ols.intercept) - ols64["intercept"])
        ok_ols = err <= ols64["coef_tol"] and err_b <= ols64["intercept_tol"]
        holds[f"ols_{tag}"] = {"coef_err_over_tol": err / ols64["coef_tol"],
                               "intercept_err_over_tol": err_b / ols64["intercept_tol"], "held": ok_ols}
    # streamed f64 against resident f64: PCA entry by entry within 8·√n·u of
    # each array's largest entry; LogisticRegression on its f64 objective
    ps, pr = models["pca_streamed", "f64"], models["pca", "f64"]
    pca_s = {a: float(np.abs(np.asarray(getattr(ps, a)) - np.asarray(getattr(pr, a))).max()
                      / np.abs(np.asarray(getattr(pr, a))).max()) / band
             for a in ("mean_", "explained_variance_", "components_")}
    ls, lr5 = models["logreg_streamed", "f64"], models["logreg_5", "f64"]
    f_s, f_r = obj.objective_of(ls.coef_, ls.intercept_), obj.objective_of(lr5.coef_, lr5.intercept_)
    lr_s = {"objective_gap_over_band": abs(f_s - f_r) / (band * abs(f_r)),
            "coef_rel_diff": float(np.abs(ls.coef_ - lr5.coef_).max() / np.abs(lr5.coef_).max()),
            "coef_rel_diff_over_band": float(np.abs(ls.coef_ - lr5.coef_).max() / np.abs(lr5.coef_).max()) / band,
            "n_iter": [ls.n_iter_, lr5.n_iter_]}
    # LogisticRegression against the f64 L-BFGS of the phase's own objective
    lr = models["logreg", "f64"]
    lr_ref = {"coef_max_abs_diff": float(np.abs(lr.coef_.reshape(-1) - ref_coef).max()),
              "intercept_abs_diff": abs(float(lr.intercept) - ref_b), "atol": F64_LR_ATOL,
              "n_iter": [lr.n_iter_, ref.n_iter], "objective_f64": obj.objective_of(lr.coef_, lr.intercept_),
              "reference_objective_f64": ref.f,
              "f32_coef_max_abs_diff": float(np.abs(models["logreg", "f32"].coef_.reshape(-1) - ref_coef).max())}
    # KMeans f64 against f32 on the same rows from the same seeds
    km64, km32 = models["kmeans", "f64"], models["kmeans", "f32"]
    cost_tol = U32 * (TOL_TERMS + TOL_WALK * n ** 0.5) * km64.trainingCost
    km = {"agreement": float((pred64 == pred32).mean()), "cost_f64": km64.trainingCost, "cost_f32": km32.trainingCost,
          "cost_diff": abs(km64.trainingCost - km32.trainingCost), "cost_tol": cost_tol,
          "n_iter": [km64.numIter, km32.numIter]}
    emit({"phase": "f64", "check": "holds", "rows": n, "band_8_sqrt_n_u": band, "vs_truth": holds,
          "pca_streamed_vs_resident_over_band": pca_s, "logreg_streamed_vs_resident": lr_s,
          "logreg_vs_f64_lbfgs": lr_ref, "kmeans_f64_vs_f32": km, "s": time.perf_counter() - t0})
    check(holds["pca_f64"]["held"] and holds["ols_f64"]["held"], f"f64 PCA or OLS off its f64 truth: {holds}")
    check(not holds["pca_f32"]["held"] and not holds["ols_f32"]["held"],
          f"negative control: an f32 fit meets the f64 band: {holds}")
    check(all(v <= 1.0 for v in pca_s.values()), f"streamed f64 PCA off the resident f64 fit: {pca_s}")
    check(lr_s["objective_gap_over_band"] <= 1.0, f"streamed f64 LogisticRegression off the resident: {lr_s}")
    check(lr_ref["coef_max_abs_diff"] <= F64_LR_ATOL and lr_ref["intercept_abs_diff"] <= F64_LR_ATOL,
          f"f64 LogisticRegression off its f64 L-BFGS: {lr_ref}")
    check(km["agreement"] >= F64_KM_AGREE_MIN and km["cost_diff"] <= cost_tol, f"KMeans f64 vs f32: {km}")
    del Xd, obj, frames, models
    torch.cuda.empty_cache()
    return {row: paths for row, paths in launches.items() if paths}


def f64_probe(torch, args, dev) -> int:
    """Phase (q) alone, on min(``--rows``, F64_ROWS) rows made from ``--seed``."""
    t0 = time.perf_counter()
    n = min(args.rows, F64_ROWS)
    X, _ = make_data(torch, n, n, args.seed, dev)
    X_host = X.cpu().numpy()
    del X
    torch.cuda.empty_cache()
    launches = phase_f64(torch, X_host, args.seed)
    emit({"phase": "done", "total_s": time.perf_counter() - t0, "launches": launches})
    return 0


# ---------------------------------------------------------------------------
# phase (r): tuning — CrossValidator, OneVsRest and Pipeline
# ---------------------------------------------------------------------------

TUNING_ROWS = 1_572_864
TUNING_RF_ROWS = 65_536
TUNING_CPU_ROWS = 131_072
TUNING_CLASSES = 10
TUNING_INFORMATIVE = 16
# the binomial labels' logit scale: a weak signal (Bayes accuracy ~0.6), so
# the grid's penalties move the CV's accuracy by ~0.002, some 90 rows a fold,
# and its best map stands clear of card-vs-CPU rounding
TUNING_SIGNAL = 0.5
TUNING_LR_ITER = 20
TUNING_FOLDS = 3
TUNING_GRIDS = {"logreg": {"regParam": [1e-4, 1e-2], "elasticNetParam": [0.0, 0.5]},
                "linreg": {"regParam": [0.0, 0.01, 100.0], "elasticNetParam": [0.0, 0.5]},
                "rf": {"maxDepth": [4, 8]}}
# rows whose p1 lies this close to 0.5 may be predicted either way by two
# products of different shapes (the combined model's one (m·K, d) product
# and each model's own (K, d) one)
TUNING_NEAR_HALF = 1e-5
# the card's CV against the CPU's: avgMetrics entry by entry
TUNING_CPU_ATOL = 1e-3
# a fold's OLS candidate's rmse against the f64 normal equations' (relative)
TUNING_RMSE_RTOL = 1e-5
# OneVsRest's accuracy at most this far below the multinomial fit's (the
# JAX package's tests/test_pipeline.py)
TUNING_OVR_SLACK = 0.05


def tuning_labels(torch, Xd, seed):
    """The phase's labels for the card's rows ``Xd``, numpy's draws from
    ``seed`` (the products on the card in f64): binomial with p =
    sigmoid(TUNING_SIGNAL·z), z = X·w standardized, w on TUNING_INFORMATIVE
    of the columns (so an L1 penalty has columns to drop); TUNING_CLASSES classes,
    the argmax of 2·X·W standardized plus Gumbel noise; a regression target
    (``linreg_labels``). Returns host f32 (binomial, classes, target)."""
    rng = np.random.default_rng(seed + 27)
    n, d = Xd.shape
    W = rng.normal(size=(d, 1 + TUNING_CLASSES))
    W[rng.permutation(d)[TUNING_INFORMATIVE:], 0] = 0.0
    z = Xd.to(torch.float64) @ torch.from_numpy(W).to(Xd.device)
    z = ((z - z.mean(dim=0)) / z.std(dim=0)).cpu().numpy()
    yb = (rng.random(n) < 1.0 / (1.0 + np.exp(-TUNING_SIGNAL * z[:, 0]))).astype(np.float32)
    yk = (2.0 * z[:, 1:] + rng.gumbel(size=(n, TUNING_CLASSES))).argmax(axis=1).astype(np.float32)
    yr, _ = linreg_labels(torch, Xd, seed + 28)
    return yb, yk, yr


def cv_of(est, grid, eva, **kw):
    """A ``CrossValidator`` over ``est`` with the grid {param name: values}."""
    from spark_rapids_ml_tpu_torch.tuning import CrossValidator, ParamGridBuilder

    b = ParamGridBuilder()
    for name, values in grid.items():
        b.addGrid(est.getParam(name), values)
    return CrossValidator(estimator=est, estimatorParamMaps=b.build(), evaluator=eva, **kw)


def single_vs_loop(torch, fast, loop, folds):
    """The single-pass CV's sub-models (``fast``) against the per-map loop's
    (``loop``) on the same folds: the coefficients bit for bit, then each
    fold's combined transform (one product of the stacked coefficients)
    against each model's own, their predictions equal but for rows whose p1
    lies within TUNING_NEAR_HALF of 0.5. Returns the comparison."""
    from spark_rapids_ml_tpu_torch.classification import LogisticRegressionModel

    coef_equal, differ, far, near_rows = True, [], 0, 0
    for (_, val), subs_f, subs_l in zip(folds, fast.subModels, loop.subModels):
        for a, b in zip(subs_f, subs_l):
            coef_equal &= np.array_equal(a.coef_, b.coef_) and np.array_equal(a.intercept_, b.intercept_)
        out = LogisticRegressionModel._combine(subs_f).transform(val)
        pred, prob = out.column("prediction"), out.column("probability")
        row = []
        for j, m in enumerate(subs_l):
            own = m.transform(val)
            p1 = own.column("probability")[:, 1]
            near = np.abs(p1.astype(np.float64) - 0.5) <= TUNING_NEAR_HALF
            d = pred[:, j] != own.column("prediction")
            row.append(int(d.sum()))
            far += int((d & ~near).sum())
            near_rows += int(near.sum())
            del own
        differ.append(row)
        del out, pred, prob
    n_val = [v.count() for _, v in folds]
    # |Δaccuracy| of map j: at most its differing rows over each fold's rows
    bound = [float(np.mean([differ[i][j] / n_val[i] for i in range(len(folds))])) for j in range(len(differ[0]))]
    gap = [abs(a - b) for a, b in zip(fast.avgMetrics, loop.avgMetrics)]
    return {"sub_models_bit_equal": bool(coef_equal), "differing_rows": differ, "differing_rows_off_threshold": far,
            "rows_within_1e-5_of_half": near_rows, "avg_gap": gap, "avg_gap_bound": bound,
            "held": bool(coef_equal and far == 0 and all(g <= b for g, b in zip(gap, bound)))}


def phase_tuning(torch, X_host, seed):
    """(r) the meta-algorithms on the first TUNING_ROWS host rows with the
    phase's own labels (``tuning_labels``): CrossValidator over
    LogisticRegression (its single pass: ``fitMultiple``, ``_combine``, one
    ``_transformEvaluate`` a fold), over LinearRegression and over
    RandomForestClassifier (its first TUNING_RF_ROWS), OneVsRest over
    LogisticRegression on TUNING_CLASSES classes, and Pipeline([PCA(k=16),
    LogisticRegression]) saved and loaded. Holds: the folds equal numpy's
    draw; the single pass against the per-map loop (``single_vs_loop``);
    parallelism 3 against 1 bit for bit; the card's CV against the CPU's on
    the first TUNING_CPU_ROWS (the same best index, avgMetrics within
    TUNING_CPU_ATOL); each fold's OLS candidate within ``ols_reference``'s
    band of an f64 normal-equations fit of its training rows and its rmse
    within TUNING_RMSE_RTOL of that fit's, regParam 100 never chosen; each
    forest sub-model's metric from the combined ``_transformEvaluate`` equal
    to its own transform's bit for bit; OneVsRest's raw columns equal to its
    binary models' raw scores bit for bit, its accuracy within
    TUNING_OVR_SLACK of the multinomial fit's; the Pipeline's predictions
    after save and load bit for bit; each with a negative control. The card
    work launches K1, K3, K5 (or K6) and K9 and calls no plain version.
    Returns {kernels-line row: launches}."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame
    from spark_rapids_ml_tpu_torch.classification import (
        LogisticRegression, OneVsRest, RandomForestClassificationModel, RandomForestClassifier)
    from spark_rapids_ml_tpu_torch.data.dataframe import kfold, kfold_ids
    from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator, RegressionEvaluator
    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.ops import linalg as lin
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel
    from spark_rapids_ml_tpu_torch.regression import LinearRegression

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    n = min(TUNING_ROWS, X_host.shape[0])
    X = np.ascontiguousarray(X_host[:n])
    Xd = torch.from_numpy(X).to(dev)
    yb, yk, yr = tuning_labels(torch, Xd, seed)
    del Xd
    torch.cuda.empty_cache()
    df = DataFrame({"features": X, "label": yb})
    acc = MulticlassClassificationEvaluator(metricName="accuracy")
    rmse = RegressionEvaluator(metricName="rmse")
    lr = lambda **kw: LogisticRegression(maxIter=TUNING_LR_ITER, **kw)
    wrappers = ((lin, "shifted_gram", "shifted_gram_plain"), (lk, "logreg_loss_grad", "logreg_loss_grad_plain"),
                (rk, "node_hist_batched", "node_hist_plain"), (rk, "node_hist_sel_batched", "node_hist_sel_plain"),
                (rk, "packed_forest_eval", "packed_forest_eval_plain"))
    for mod, w, _ in wrappers:
        getattr(mod, w).launches = 0
    parts, counts = {}, {}

    def part(name, fn):
        with launch_counts(wrappers) as rec:
            out, parts[name] = _timed(torch, fn)
            counts[name] = {k: v for k, v in rec().items() if v}
        return out

    # the folds: one numpy draw
    ids = kfold_ids(n, TUNING_FOLDS, seed)
    want = np.random.default_rng(seed).integers(0, TUNING_FOLDS, size=n).astype(np.int8)
    folds = kfold(df, TUNING_FOLDS, seed)
    split = {"ids_equal": bool(np.array_equal(ids, want)),
             "rows_equal": all(np.array_equal(v.column("features"), X[ids == i]) and
                               np.array_equal(t.column("label"), yb[ids != i]) for i, (t, v) in enumerate(folds)),
             "control_other_seed_differs": not np.array_equal(kfold_ids(n, TUNING_FOLDS, seed + 1), ids),
             "val_rows": [v.count() for _, v in folds]}
    emit({"phase": "tuning", "check": "folds", **split})
    check(split["ids_equal"] and split["rows_equal"] and split["control_other_seed_differs"],
          f"tuning: the folds are not numpy's draw: {split}")

    # CrossValidator(LogisticRegression): single pass, per-map loop, threads
    grid = TUNING_GRIDS["logreg"]
    fast = part("logreg_cv", lambda: cv_of(lr(), grid, acc, numFolds=TUNING_FOLDS, seed=seed,
                                           collectSubModels=True).fit(df))
    slow_est = lr()
    slow_est._supportsTransformEvaluate = lambda e: False
    loop = part("logreg_cv_loop", lambda: cv_of(slow_est, grid, acc, numFolds=TUNING_FOLDS, seed=seed,
                                                collectSubModels=True).fit(df))
    par = part("logreg_cv_parallel3", lambda: cv_of(lr(), grid, acc, numFolds=TUNING_FOLDS, seed=seed,
                                                    parallelism=3).fit(df))
    svl = part("logreg_single_vs_loop", lambda: single_vs_loop(torch, fast, loop, folds))
    del folds
    lr_cv = {"avgMetrics": fast.avgMetrics, "stdMetrics": fast.stdMetrics, "loop_avgMetrics": loop.avgMetrics,
             "single_vs_loop": svl, "parallel3_avgMetrics": par.avgMetrics,
             "parallel3_bit_equal": par.avgMetrics == fast.avgMetrics}
    fast.subModels = loop.subModels = None

    # card vs CPU on the first rows; there, the folds of another seed (the
    # control of the equalities above: other folds, other metrics)
    m = min(TUNING_CPU_ROWS, n)
    dfc = DataFrame({"features": X[:m], "label": yb[:m]})
    card = part("logreg_cv_card_small", lambda: cv_of(lr(), grid, acc, numFolds=TUNING_FOLDS, seed=seed).fit(dfc))
    other = part("logreg_cv_card_small_seed_plus_1", lambda: cv_of(lr(), grid, acc, numFolds=TUNING_FOLDS,
                                                                   seed=seed + 1).fit(dfc))
    lr_cv["control_seed_plus_1_avgMetrics"] = other.avgMetrics
    lr_cv["control_seed_plus_1_differs"] = other.avgMetrics != card.avgMetrics
    t = time.perf_counter()
    cpu = cv_of(lr(device="cpu"), grid, acc, numFolds=TUNING_FOLDS, seed=seed).fit(dfc)
    strong = {"regParam": [100 * v for v in grid["regParam"]], "elasticNetParam": grid["elasticNetParam"]}
    cpu_strong = cv_of(lr(device="cpu"), strong, acc, numFolds=TUNING_FOLDS, seed=seed).fit(dfc)
    parts["logreg_cv_cpu_small_and_control"] = time.perf_counter() - t
    best = lambda cv: int(np.argmax(cv.avgMetrics))
    gap = max(abs(a - b) for a, b in zip(card.avgMetrics, cpu.avgMetrics))
    ctl = max(abs(a - b) for a, b in zip(card.avgMetrics, cpu_strong.avgMetrics))
    lr_cv["card_vs_cpu"] = {"rows": m, "card_avgMetrics": card.avgMetrics, "cpu_avgMetrics": cpu.avgMetrics,
                            "best": [best(card), best(cpu)], "max_gap": gap, "atol": TUNING_CPU_ATOL,
                            "control_cpu_regParam_x100_avgMetrics": cpu_strong.avgMetrics, "control_max_gap": ctl}
    emit({"phase": "tuning", "check": "logreg_cv", **lr_cv})
    check(svl["held"], f"tuning: the single pass off the per-map loop: {svl}")
    check(lr_cv["parallel3_bit_equal"] and lr_cv["control_seed_plus_1_differs"],
          f"tuning: parallelism 3 against 1, or the fold-seed control: {lr_cv}")
    check(best(card) == best(cpu) and gap <= TUNING_CPU_ATOL and ctl > TUNING_CPU_ATOL,
          f"tuning: the card's CV against the CPU's: {lr_cv['card_vs_cpu']}")

    # CrossValidator(LinearRegression): each fold's OLS candidate against f64
    dfr = DataFrame({"features": X, "label": yr})
    lcv = part("linreg_cv", lambda: cv_of(LinearRegression(), TUNING_GRIDS["linreg"], rmse, numFolds=TUNING_FOLDS,
                                          seed=seed, collectSubModels=True).fit(dfr))
    ols = []
    t = time.perf_counter()
    Xd = torch.from_numpy(X).to(dev)
    fold_d = torch.from_numpy(ids).to(dev)
    for i, subs in enumerate(lcv.subModels):
        # the fold's rows split on the card, outside the port
        ref = ols_reference(torch, Xd[fold_d != i], yr[ids != i])
        Xv = Xd[fold_d == i].to(torch.float64)
        yv = torch.from_numpy(yr[ids == i]).to(dev, torch.float64)
        pred = Xv @ torch.from_numpy(ref["beta"]).to(dev) + ref["intercept"]
        rmse_ref = float(((pred - yv) ** 2).mean().sqrt())
        del Xv, yv, pred
        val = DataFrame({"features": X[ids == i], "label": yr[ids == i]})
        row = {"rmse_f64": rmse_ref}
        for tag, sub in (("ols", subs[0]), ("control_regParam_100", subs[4])):
            dev_s = ref["std"] * (np.asarray(sub.coefficients, np.float64) - ref["beta"])
            err = float(np.linalg.norm(dev_s) / np.linalg.norm(ref["std"] * ref["beta"]))
            err_b = abs(float(sub.intercept) - ref["intercept"])
            r = rmse.evaluate(sub.transform(val))
            row[tag] = {"coef_err_over_tol": err / ref["coef_tol"], "intercept_err_over_tol": err_b / ref[
                "intercept_tol"], "rmse": r, "rmse_rel_diff": abs(r - rmse_ref) / rmse_ref,
                "held": err <= ref["coef_tol"] and err_b <= ref["intercept_tol"] and abs(
                    r - rmse_ref) <= TUNING_RMSE_RTOL * rmse_ref}
        ols.append(row)
    parts["linreg_cv_f64_reference"] = time.perf_counter() - t
    del Xd, fold_d, val
    torch.cuda.empty_cache()
    lin_best = int(np.argmin(lcv.avgMetrics))
    emit({"phase": "tuning", "check": "linreg_cv", "avgMetrics": lcv.avgMetrics, "stdMetrics": lcv.stdMetrics,
          "best": lin_best, "folds": ols})
    check(all(r["ols"]["held"] for r in ols) and not any(r["control_regParam_100"]["held"] for r in ols),
          f"tuning: an OLS candidate off its f64 fit, or the regParam 100 control held: {ols}")
    check(lin_best not in (4, 5), f"tuning: regParam 100 chosen: {lcv.avgMetrics}")
    lcv.subModels = None

    # CrossValidator(RandomForestClassifier): the combined evaluation pass
    r_rows = min(TUNING_RF_ROWS, n)
    dff = DataFrame({"features": X[:r_rows], "label": yb[:r_rows]})
    rf = RandomForestClassifier(numTrees=10, maxBins=32, seed=seed)
    rcv = part("rf_cv", lambda: cv_of(rf, TUNING_GRIDS["rf"], acc, numFolds=2, seed=seed,
                                      collectSubModels=True).fit(dff))
    rf_rows = []

    def rf_holds():
        for (_, val), subs in zip(kfold(dff, 2, seed), rcv.subModels):
            combined = RandomForestClassificationModel._combine(subs)
            vals = combined._transformEvaluate(val, acc)
            own = [acc.evaluate(s.transform(val)) for s in subs]
            rf_rows.append({"combined": vals, "own": own, "equal": vals == own,
                            "control_maps_differ": vals[0] != vals[1]})

    part("rf_cv_holds", rf_holds)
    emit({"phase": "tuning", "check": "rf_cv", "rows": r_rows, "avgMetrics": rcv.avgMetrics,
          "stdMetrics": rcv.stdMetrics, "folds": rf_rows,
          "fit_reports": [s._fit_report for s in rcv.subModels[0]]})
    check(all(r["equal"] and r["control_maps_differ"] for r in rf_rows),
          f"tuning: a forest sub-model's combined metric off its own: {rf_rows}")
    rcv.subModels = None

    # OneVsRest(LogisticRegression) on TUNING_CLASSES classes
    dfk = DataFrame({"features": X, "label": yk})
    ovr = part("ovr_fit", lambda: OneVsRest(classifier=lr(regParam=1e-4)).fit(dfk))
    out = part("ovr_transform", lambda: ovr.transform(dfk))
    raw, pred = out.column("rawPrediction"), out.column("prediction")
    multi = part("multinomial_fit", lambda: lr(regParam=1e-4).fit(dfk))
    acc_multi = float((multi.transform(dfk).column("prediction") == yk).mean())
    acc_ovr = float((pred == yk).mean())
    dfs = DataFrame({"features": X[:m]})
    cols = [ovr.models[k].transform(dfs).column("rawPrediction")[:, 1] for k in range(TUNING_CLASSES)]
    ovr_row = {"shape": list(raw.shape), "columns_bit_equal": all(np.array_equal(raw[:m, k], c)
                                                                   for k, c in enumerate(cols)),
               "control_next_model_differs": not np.array_equal(raw[:m, 0], cols[1]),
               "accuracy": acc_ovr, "multinomial_accuracy": acc_multi, "n_iter": [mm.n_iter_ for mm in ovr.models]}
    emit({"phase": "tuning", "check": "one_vs_rest", **ovr_row})
    check(ovr_row["shape"] == [n, TUNING_CLASSES] and ovr_row["columns_bit_equal"] and
          ovr_row["control_next_model_differs"] and acc_ovr >= acc_multi - TUNING_OVR_SLACK,
          f"tuning: OneVsRest: {ovr_row}")
    del out, raw, pred, cols, ovr, multi

    # Pipeline([PCA(k=16), LogisticRegression]), saved and loaded
    pipe = Pipeline(stages=[PCA(k=16, inputCol="features", outputCol="pca"),
                            lr(featuresCol="pca", regParam=1e-4)])
    pm = part("pipeline_fit", lambda: pipe.fit(dfk))
    p1 = part("pipeline_transform", lambda: pm.transform(dfk).column("prediction"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        pm.write().overwrite().save(path)
        loaded = PipelineModel.load(path)
    p2 = part("pipeline_loaded_transform", lambda: loaded.transform(dfk).column("prediction"))
    flipped = loaded.stages[1]
    flipped._model_attributes["coef_"] = -np.asarray(flipped.coef_)
    flipped._transform_fn_cache = {}
    p3 = loaded.transform(dfk).column("prediction")
    pipe_row = {"bit_equal": bool(np.array_equal(p1, p2)), "control_negated_coefficients_differ":
                not np.array_equal(p1, p3), "accuracy": float((p1 == yk).mean())}
    emit({"phase": "tuning", "check": "pipeline", **pipe_row})
    check(pipe_row["bit_equal"] and pipe_row["control_negated_coefficients_differ"], f"tuning: Pipeline: {pipe_row}")

    total = {k: sum(c.get(k, 0) for c in counts.values()) for k in [w for _, w, _ in wrappers] + [
        p for _, _, p in wrappers]}
    emit({"phase": "tuning", "check": "launches", "rows": n, "by_part": counts, "total": total, "parts_s": parts,
          "s": time.perf_counter() - t0})
    check(total["shifted_gram"] > 0 and total["logreg_loss_grad"] > 0 and total["packed_forest_eval"] > 0 and
          total["node_hist_batched"] + total["node_hist_sel_batched"] > 0 and
          not any(v for k, v in total.items() if k.endswith("_plain")),
          f"tuning: a kernel of the path not launched, or a plain version ran on the card: {total}")
    return {w: total[w] for _, w, _ in wrappers if total[w]}


def tuning_probe(torch, args, dev) -> int:
    """Phase (r) alone, on min(``--rows``, TUNING_ROWS) rows made from ``--seed``."""
    t0 = time.perf_counter()
    n = min(args.rows, TUNING_ROWS)
    X, _ = make_data(torch, n, n, args.seed, dev)
    X_host = X.cpu().numpy()
    del X
    torch.cuda.empty_cache()
    launches = phase_tuning(torch, X_host, args.seed)
    emit({"phase": "done", "total_s": time.perf_counter() - t0, "launches": launches})
    return 0


def trustworthiness(torch, X, E, k: int) -> float:
    """sklearn.manifold.trustworthiness (euclidean) of the embedding ``E``
    of the rows ``X``, in f64 on their device: 1 minus the normalized sum
    of how far beyond k each embedding-space neighbour ranks in input
    space."""
    n = X.shape[0]
    X, E = X.to(torch.float64), E.to(torch.float64)
    dX = torch.cdist(X, X)
    dX.fill_diagonal_(float("inf"))
    ind_X = torch.argsort(dX, dim=1)
    del dX
    dE = torch.cdist(E, E)
    dE.fill_diagonal_(float("inf"))
    ind_E = torch.topk(dE, k, dim=1, largest=False).indices
    ranks_of = torch.empty_like(ind_X)
    ranks_of.scatter_(1, ind_X, torch.arange(1, n + 1, device=X.device).expand(n, n))
    ranks = ranks_of.gather(1, ind_E) - k
    t = float(ranks[ranks > 0].sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def _trust_sample(torch, X, E, seed):
    rows = np.random.default_rng(seed).choice(X.shape[0], size=min(TRUST_ROWS, X.shape[0]), replace=False)
    dev = torch.device("cuda:0")
    return trustworthiness(torch, torch.from_numpy(X[rows]).to(dev), torch.from_numpy(E[rows]).to(dev),
                           UMAP_NEIGHBORS)


def phase_knn_e2e(torch, Xi_host):
    """NearestNeighbors(k=16) through DataFrame: the first 131,072 item rows
    queried against all items (bench.py's kNN entry)."""
    from spark_rapids_ml_tpu_torch import DataFrame, NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    ni = Xi_host.shape[0]
    nq = min(KNN_QUERIES, ni)
    item_df = DataFrame({"features": Xi_host})
    query_df = DataFrame({"features": Xi_host[:nq]})
    kn.knn_topk_pass.launches = 0
    model = NearestNeighbors(k=KNN_K).fit(item_df)
    (_, _, knn_df), t = _timed(torch, lambda: model.kneighbors(query_df))
    launches = kn.knn_topk_pass.launches
    idx = np.asarray(knn_df.column("indices"))
    dist = np.asarray(knn_df.column("distances"))
    check(idx.shape == (nq, KNN_K) and np.isfinite(dist).all(), "kneighbors output shape or finiteness")
    check(bool((np.diff(dist, axis=1) >= 0).all()), "kneighbors distances not ascending")
    # every query is an item: its nearest neighbour is itself, at distance
    # 0 up to the f32 rounding of ||x||² - 2x·x + ||x||² (TAU band)
    self_ok = float((idx[:, 0] == np.arange(nq)).mean())
    xsq = (Xi_host[:nq].astype(np.float64) ** 2).sum(axis=1)
    self_tol = np.sqrt(TAU_UNITS * U32 * E2E_D ** 0.5 * 4.0 * xsq)
    check(self_ok == 1.0 and bool((dist[:, 0] <= self_tol).all()),
          f"kNN self match {self_ok}, self distance up to {float(dist[:, 0].max())}")
    nj = min(4096, ni)
    join_q = DataFrame({"features": Xi_host[:nj], "tag": np.arange(nj)})
    joined, t_join = _timed(torch, lambda: model.exactNearestNeighborsJoin(join_q))
    check(joined.count() == nj * KNN_K and np.isfinite(np.asarray(joined.column("distCol"))).all(),
          "exactNearestNeighborsJoin rows")
    launches_all = kn.knn_topk_pass.launches
    res = {"phase": "e2e", "estimator": "NearestNeighbors", "k": KNN_K, "queries": nq, "items": ni,
           "kneighbors_s": t, "queries_per_s": nq / t, "self_match": self_ok,
           "self_distance_max": float(dist[:, 0].max()), "join_queries": nj, "join_s": t_join,
           "knn_topk_launches": launches, "knn_topk_launches_with_join": launches_all}
    emit(res)
    check(launches > 0, "kernel knn_topk was not launched by kneighbors")
    return launches_all


def phase_umap_e2e(torch, X, seed, path="umap", save=True, **params):
    """UMAP(random_state=42, **params) fit and transform of the same rows
    (``params``: n_neighbors 15 and the defaults unless given), held by
    trustworthiness on a 4,096-row sample, and (``save``) a save/load round
    trip. K10 must run once an epoch (its STEP epilogue: 200 fit epochs and
    66 refine epochs at these sizes) and its ROWS epilogue never."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, UMAP, UMAPModel
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    def counts():
        return {"knn_topk": kn.knn_topk_pass.launches, "sgd_epoch_step": uk.sgd_epoch_step.launches,
                "sgd_epoch_rows": uk.sgd_epoch_rows.launches}

    n = X.shape[0]
    params = {"n_neighbors": UMAP_NEIGHBORS, **params}
    C = params.get("n_components", 2)
    df = DataFrame({"features": X})
    kn.knn_topk_pass.launches = uk.sgd_epoch_step.launches = uk.sgd_epoch_rows.launches = 0
    model, t_fit = _timed(torch, lambda: UMAP(random_state=42, **params).fit(df))
    fit_launches = counts()
    out, t_tr = _timed(torch, lambda: model.transform(df))
    launches = counts()
    emb, emb_t = model.embedding_, np.asarray(out.column("embedding"))
    check(emb.shape == (n, C) and np.isfinite(emb).all(), f"{path}: UMAP embedding shape or finiteness")
    check(emb_t.shape == (n, C) and np.isfinite(emb_t).all(), f"{path}: UMAP transform shape or finiteness")
    trust_fit = _trust_sample(torch, X, emb, seed)
    trust_tr = _trust_sample(torch, X, emb_t, seed)
    check(trust_fit > TRUST_MIN and trust_tr > TRUST_MIN,
          f"{path}: UMAP trustworthiness fit {trust_fit}, transform {trust_tr} not above {TRUST_MIN}")
    rep = model._fit_report
    refine = model._transform_report["refine_epochs"]
    line = {"phase": "e2e", "estimator": "UMAP", "path": path, **params, "rows": n,
            "fit_s": t_fit, "transform_s": t_tr, "graph_s": rep["graph_seconds"],
            "init_s": rep["init_seconds"], "sgd_s": rep["sgd_seconds"], "epoch_ms": rep["epoch_ms"],
            "n_epochs": rep["n_epochs"], "sgd_rows": rep["rows"], "refine_epochs": refine,
            "trustworthiness_fit": trust_fit, "trustworthiness_transform": trust_tr,
            "trust_rows": TRUST_ROWS, "trust_min": TRUST_MIN, "fit_launches": fit_launches, "launches": launches}
    if save:
        with tempfile.TemporaryDirectory() as tmp:
            (_, line["save_s"]) = _timed(torch, lambda: model.write().overwrite().save(tmp + "/umap"))
            loaded, line["load_s"] = _timed(torch, lambda: UMAPModel.load(tmp + "/umap"))
        part = DataFrame({"features": X[:4096]})
        same_emb = bool(np.array_equal(loaded.embedding_, emb))
        tr_a = np.asarray(model.transform(part).column("embedding"))
        tr_b = np.asarray(loaded.transform(part).column("embedding"))
        check(same_emb and np.array_equal(tr_a, tr_b), f"{path}: UMAP save/load round trip changed the model")
    emit(line)
    check(fit_launches["knn_topk"] > 0 and launches["knn_topk"] > fit_launches["knn_topk"],
          f"{path}: kernel knn_topk was not launched by the fit and the transform")
    # one K10 launch an epoch, and nothing of the ROWS epilogue
    check(fit_launches["sgd_epoch_step"] == rep["n_epochs"]
          and launches["sgd_epoch_step"] - fit_launches["sgd_epoch_step"] == refine
          and launches["sgd_epoch_rows"] == 0,
          f"{path}: K10 launches {fit_launches} (fit, {rep['n_epochs']} epochs), {launches} (with the "
          f"transform's {refine})")
    return launches


def phase_umap_subset(torch, X_all, seed, rows, inits=("spectral", "random"), **params):
    """The same UMAP fitted on the card and on the CPU (plain path) on the
    first ``rows`` rows. For the 32-blob rows, with the default spectral
    init and with a random one: on 32 nearly disconnected blobs the
    spectral init's leading eigenvectors are nearly degenerate, so the f32
    rounding that separates the two graphs can move the init (and the
    final trustworthiness by ~0.01); the random init isolates the SGD."""
    from spark_rapids_ml_tpu_torch import DataFrame, UMAP

    X = X_all[:rows]
    df = DataFrame({"features": X})
    params = {"n_neighbors": UMAP_NEIGHBORS, **params}
    for init in inits:
        trust, secs = {}, {}
        for dev in ("cuda:0", "cpu"):
            m, secs[dev] = _timed(torch, lambda: UMAP(random_state=42, init=init, device=dev, **params).fit(df))
            trust[dev] = _trust_sample(torch, X, m.embedding_, seed)
        diff = abs(trust["cuda:0"] - trust["cpu"])
        emit({"phase": "subset", "estimator": "UMAP", **params, "init": init, "rows": rows,
              "trust_card": trust["cuda:0"], "trust_cpu": trust["cpu"], "trust_diff": diff, "trust_diff_tol": 0.03,
              "fit_s_card": secs["cuda:0"], "fit_s_cpu": secs["cpu"]})
        check(diff <= 0.03, f"UMAP ({init} init, {params}) card vs CPU trustworthiness differ by {diff}")


RF_WRAPPERS = ("node_hist_batched", "node_hist_sel_batched", "packed_forest_eval", "packed_traverse",
               "packed_byte_gather_many", "packed_byte_gather")


def _rf_counts(rk, zero=False):
    out = {}
    for name in RF_WRAPPERS:
        w = getattr(rk, name)
        out[name] = w.launches
        if zero:
            w.launches = 0
    return out


def regression_label(X, seed):
    """A real-valued label from ``--seed``: a linear part, a bend, noise."""
    rng = np.random.default_rng(seed + 11)
    w = rng.normal(size=8).astype(np.float32)
    return (X[:, :8] @ w + np.sin(X[:, 8]) + 0.3 * rng.normal(size=X.shape[0])).astype(np.float32)


def bins_engine_equal(torch, model, X, packed_out, what):
    """The model's bins engine (K8) on the same rows: every column equal to
    the packed engine's (K9) bit for bit. Returns its seconds."""
    fn = model._get_transform_func(engine="bins")
    out, secs = _timed(torch, lambda: model._apply_batched(fn, X))
    for c in model._out_cols():
        check(np.array_equal(out[c], packed_out.column(c)), f"{what}: bins and packed engines differ in {c}")
    return secs


def phase_rf_e2e(torch, X_host, y_host, seed):
    """The forest paths through ``DataFrame``, each with the launch counters
    zeroed just before it and read just after: bench.py's classifier (fit,
    transform, the bins engine, save/load, transform), the regressor on a
    real-valued label, the reference's regressor config (30 trees of depth
    6: K9 walks hop 1 alone) on the same rows and label, and the
    3,000-feature classifier at the reference's 1,000,000 rows (fit;
    transform, one K9 launch a batch, and the bins engine on all of them),
    with its first RF_WIDE_SUBSET_ROWS rows fitted on the card and on the
    CPU. Returns {kernel: {path: launches}}."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier, RandomForestRegressor
    from spark_rapids_ml_tpu_torch.classification import RandomForestClassificationModel
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    X, y = X_host[:RF_ROWS], y_host[:RF_ROWS]
    n = X.shape[0]
    by_path = {name: {} for name in RF_WRAPPERS}
    feats = DataFrame({"features": X})

    def record(path, counts, needed):
        for name, c in counts.items():
            by_path[name][path] = c
        for name in needed:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")

    # 1. bench.py's rf config
    _rf_counts(rk, zero=True)
    est = RandomForestClassifier(numTrees=RF_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    model, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": y})))
    fit_counts = _rf_counts(rk)
    out, t_tr = _timed(torch, lambda: model.transform(feats))
    pred, prob = out.column("prediction"), out.column("probability")
    with tempfile.TemporaryDirectory() as tmp:
        (_, t_save) = _timed(torch, lambda: model.write().overwrite().save(tmp + "/rf"))
        loaded, t_load = _timed(torch, lambda: RandomForestClassificationModel.load(tmp + "/rf"))
    out2, t_tr2 = _timed(torch, lambda: loaded.transform(feats))
    t_bins = bins_engine_equal(torch, model, X, out, "RandomForestClassifier")
    counts = _rf_counts(rk)
    acc = float((pred == y).mean())
    check(pred.shape == (n,) and np.isfinite(prob).all() and bool((np.abs(prob.sum(1) - 1) < 1e-5).all()),
          "RandomForestClassifier transform shape, finiteness or probabilities")
    check(np.array_equal(pred, out2.column("prediction")) and np.array_equal(prob, out2.column("probability")),
          "RandomForestClassifier save/load changed the predictions")
    check(acc > 0.9, f"RandomForestClassifier training accuracy {acc} <= 0.9")
    emit({"phase": "e2e", "estimator": "RandomForestClassifier", "numTrees": RF_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "d": X.shape[1], "fit_s": t_fit, "transform_s": t_tr,
          "transform_rows_per_s": n / t_tr, "save_s": t_save, "load_s": t_load, "transform_after_load_s": t_tr2,
          "transform_bins_s": t_bins, "bins_equal_packed": True, "train_accuracy": acc,
          "nodes": model.totalNumNodes, "engine": model._resolve_transform_engine(),
          "fit_report": model._fit_report, "fit_launches": fit_counts, "launches": counts})
    record("rf_classifier", counts, ("node_hist_batched", "packed_forest_eval", "packed_byte_gather_many"))

    # 2. the regressor: a real-valued label from --seed
    yr = regression_label(X, seed)
    _rf_counts(rk, zero=True)
    est = RandomForestRegressor(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    rmodel, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": yr})))
    out, t_tr = _timed(torch, lambda: rmodel.transform(feats))
    counts = _rf_counts(rk)
    pr = out.column("prediction")
    r2 = float(1.0 - ((pr - yr) ** 2).mean() / yr.var())
    check(np.isfinite(pr).all() and r2 > 0.5, f"RandomForestRegressor training R^2 {r2} <= 0.5")
    emit({"phase": "e2e", "estimator": "RandomForestRegressor", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": n, "fit_s": t_fit, "transform_s": t_tr, "train_r2": r2,
          "nodes": rmodel.totalNumNodes, "fit_report": rmodel._fit_report, "launches": counts})
    record("rf_regressor", counts, ("node_hist_batched", "packed_forest_eval"))
    del rmodel, out

    # 3. the reference's RandomForestRegressor benchmark (BASELINE.md:27):
    # 30 trees of depth 6, hop 1 only (k2 = 0), on the bench rows
    _rf_counts(rk, zero=True)
    est = RandomForestRegressor(numTrees=RF_REF_REG_TREES, maxDepth=RF_REF_REG_DEPTH, maxBins=RF_BINS, seed=seed)
    rmodel, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": yr})))
    fit_counts = _rf_counts(rk)
    out, t_tr = _timed(torch, lambda: rmodel.transform(feats))
    counts = _rf_counts(rk)
    pr = out.column("prediction")
    r2 = float(1.0 - ((pr - yr) ** 2).mean() / yr.var())
    check(np.isfinite(pr).all() and r2 > 0.5, f"reference RandomForestRegressor training R^2 {r2} <= 0.5")
    pf = rmodel._ensure_packed()
    emit({"phase": "e2e", "estimator": "RandomForestRegressor", "path": "rf_regressor_ref",
          "numTrees": RF_REF_REG_TREES, "maxDepth": RF_REF_REG_DEPTH, "maxBins": RF_BINS, "rows": n, "d": X.shape[1],
          "reduced": f"rows and width 1,000,000 x 3,000 -> {n} x {X.shape[1]} (at 3,000 features the "
                     "regressor's onethird draws 1,000 features a node, a K6 shape no path times yet)",
          "fit_s": t_fit, "transform_s": t_tr, "transform_rows_per_s": n / t_tr, "train_r2": r2,
          "k1_k2": [pf.k1, pf.k2], "nodes": rmodel.totalNumNodes, "fit_report": rmodel._fit_report,
          "fit_launches": fit_counts, "launches": counts})
    record("rf_regressor_ref", counts, ("node_hist_batched", "packed_forest_eval"))
    del rmodel, out

    # 4. the reference's RandomForest benchmark (BASELINE.md:16,26) at its
    # rows, features, bins and depth, 8 of its 50 trees: K6 picks each
    # node's 55 features from the full rows; transform (K9, a launch a
    # batch of 131,072 rows) and the bins engine on all 1,000,000 rows
    g = torch.Generator(device="cuda:0")
    g.manual_seed(seed + 13)
    Xw = torch.randn((RF_WIDE_ROWS, RF_WIDE_D), generator=g, device="cuda:0")
    cols = torch.randperm(RF_WIDE_D, generator=g, device="cuda:0")[:30]
    yw = (Xw[:, cols].sum(dim=1) > 0).float().cpu().numpy()
    Xw = Xw.cpu().numpy()
    torch.cuda.empty_cache()
    _rf_counts(rk, zero=True)
    torch.cuda.reset_peak_memory_stats()
    est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    wmodel, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": Xw, "label": yw})))
    peak = torch.cuda.max_memory_allocated()
    fit_counts = _rf_counts(rk)
    out, t_tr = _timed(torch, lambda: wmodel.transform(DataFrame({"features": Xw})))
    tr_counts = _rf_counts(rk)
    t_bins = bins_engine_equal(torch, wmodel, Xw, out, "3,000-feature RandomForestClassifier")
    counts = _rf_counts(rk)
    batches = -(-RF_WIDE_ROWS // wmodel._transform_batch_rows())
    check(tr_counts["packed_forest_eval"] - fit_counts["packed_forest_eval"] == batches,
          f"3,000-feature transform: {tr_counts['packed_forest_eval'] - fit_counts['packed_forest_eval']} K9 "
          f"launches for {batches} batches")
    acc_w = float((out.column("prediction") == yw).mean())
    # each node sees 55 of the 3,000 features, about one of the 30 the label
    # depends on: the check is that the forest learned something
    check(acc_w > 0.6, f"3,000-feature RandomForestClassifier training accuracy {acc_w} <= 0.6")
    # every split level of every tree batch took K6 (a level's slots may go
    # in chunks: a launch each)
    check(fit_counts["node_hist_sel_batched"] >= RF_DEPTH,
          f"3,000-feature fit: {fit_counts['node_hist_sel_batched']} K6 launches for {RF_DEPTH} split levels")
    emit({"phase": "e2e", "estimator": "RandomForestClassifier", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH,
          "maxBins": RF_BINS, "rows": RF_WIDE_ROWS, "d": RF_WIDE_D,
          "reduced": "numTrees 50 -> 8 (the script's time)", "fit_s": t_fit, "transform_rows": RF_WIDE_ROWS,
          "transform_s": t_tr, "transform_rows_per_s": RF_WIDE_ROWS / t_tr, "transform_batches": batches,
          "transform_k9_launches": tr_counts["packed_forest_eval"] - fit_counts["packed_forest_eval"],
          "transform_bins_s": t_bins, "bins_equal_packed": True, "train_accuracy": acc_w,
          "peak_device_gb": peak / 1e9, "fit_report": wmodel._fit_report, "fit_launches": fit_counts,
          "launches": counts})
    record("rf_wide", counts, ("node_hist_sel_batched", "packed_forest_eval", "packed_byte_gather_many"))
    del wmodel, out
    record("rf_wide_card_vs_cpu", phase_rf_wide_subset(torch, Xw, yw, seed, RF_WIDE_SUBSET_ROWS),
           ("node_hist_sel_batched",))
    return by_path


def phase_rf_wide_subset(torch, Xw, yw, seed, rows):
    """The 3,000-feature forest's first ``rows`` rows fitted on the card
    (K6) and on the CPU (its plain version) with the same draws, 8 trees,
    depth RF_SUBSET_DEPTH: gini sums are exact integers, so the trees are
    expected to be equal. Counts the differing nodes and holds the
    predictions to RF_AGREE_MIN. Returns the launch counts."""
    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    df = DataFrame({"features": Xw[:rows], "label": yw[:rows]})
    _rf_counts(rk, zero=True)
    fits, secs, preds = {}, {}, {}
    for dev in ("cuda:0", "cpu"):
        est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_SUBSET_DEPTH, maxBins=RF_BINS,
                                     seed=seed, device=dev)
        fits[dev], secs[dev] = _timed(torch, lambda: est.fit(df))
        preds[dev] = fits[dev].transform(df).column("prediction")
    counts = _rf_counts(rk)
    a, b = fits["cuda:0"]._model_attributes, fits["cpu"]._model_attributes
    differ = int(((a["features"] != b["features"]) | (a["threshold_bins"] != b["threshold_bins"])).sum())
    agree = float((preds["cuda:0"] == preds["cpu"]).mean())
    emit({"phase": "subset", "estimator": "RandomForestClassifier", "rows": rows, "d": RF_WIDE_D,
          "numTrees": RF_SMALL_TREES, "maxDepth": RF_SUBSET_DEPTH, "nodes_differ": differ,
          "leaf_stats_differ": int((a["leaf_stats"] != b["leaf_stats"]).any(axis=2).sum()),
          "prediction_agreement": agree, "agreement_min": RF_AGREE_MIN, "fit_s_card": secs["cuda:0"],
          "fit_s_cpu": secs["cpu"], "fit_report_card": fits["cuda:0"]._fit_report, "launches": counts})
    check(agree >= RF_AGREE_MIN, f"3,000-feature forest card vs CPU predictions agree on {agree} < {RF_AGREE_MIN}")
    return counts


def phase_gbt_e2e(torch, X_host, y_host, seed):
    """bench.py's gbt config through ``DataFrame``, each estimator with the
    launch counters zeroed just before it and read just after:
    GBTClassifier (fit, transform through the packed engine, the bins
    engine, save/load, transform) on the rf rows and labels, and
    GBTRegressor (fit, both engines) on the regressor's real-valued label.
    Returns {kernel: {path: launches}}."""
    import tempfile

    from spark_rapids_ml_tpu_torch import DataFrame, GBTClassifier, GBTRegressor
    from spark_rapids_ml_tpu_torch.classification import GBTClassificationModel
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    X, y = X_host[:RF_ROWS], y_host[:RF_ROWS]
    n = X.shape[0]
    feats = DataFrame({"features": X})
    by_path = {name: {} for name in RF_WRAPPERS}
    needed = ("node_hist_batched", "packed_forest_eval", "packed_byte_gather_many")
    kw = dict(maxIter=GBT_ROUNDS, maxDepth=GBT_DEPTH, maxBins=RF_BINS, seed=seed)

    def run(path, est, label, extra):
        _rf_counts(rk, zero=True)
        model, t_fit = _timed(torch, lambda: est.fit(DataFrame({"features": X, "label": label})))
        fit_counts = _rf_counts(rk)
        out, t_tr = _timed(torch, lambda: model.transform(feats))
        t_bins = bins_engine_equal(torch, model, X, out, type(est).__name__)
        res, checks = extra(model, out)
        counts = _rf_counts(rk)
        for name, c in counts.items():
            by_path[name][path] = c
        emit({"phase": "e2e", "estimator": type(est).__name__, "maxIter": GBT_ROUNDS, "maxDepth": GBT_DEPTH,
              "maxBins": RF_BINS, "rows": n, "d": X.shape[1], "fit_s": t_fit, "transform_s": t_tr,
              "transform_rows_per_s": n / t_tr, "transform_bins_s": t_bins, "bins_equal_packed": True,
              "engine": model._resolve_transform_engine(), "k1_k2": [model._ensure_packed().k1,
                                                                    model._ensure_packed().k2],
              "trees": model.getNumTrees(), "nodes": model.totalNumNodes, "fit_report": model._fit_report,
              "fit_launches": fit_counts, "launches": counts, **res})
        for cond, msg in checks:
            check(cond, msg)
        for name in needed:
            check(counts[name] > 0, f"kernel {name} was not launched on the {path} path")

    def classifier_checks(model, out):
        pred, prob = out.column("prediction"), out.column("probability")
        with tempfile.TemporaryDirectory() as tmp:
            _, t_save = _timed(torch, lambda: model.write().overwrite().save(tmp + "/gbt"))
            loaded, t_load = _timed(torch, lambda: GBTClassificationModel.load(tmp + "/gbt"))
        out2, t_tr2 = _timed(torch, lambda: loaded.transform(feats))
        acc = float((pred == y).mean())
        checks = [(np.array_equal(out.column(c), out2.column(c)), f"GBTClassifier save/load changed {c}")
                  for c in model._out_cols()]
        checks += [
            (pred.shape == (n,) and np.isfinite(prob).all() and bool((np.abs(prob.sum(1) - 1) < 1e-5).all()),
             "GBTClassifier transform shape, finiteness or probabilities"),
            (acc > GBT_ACC_MIN, f"GBTClassifier training accuracy {acc} <= {GBT_ACC_MIN}"),
        ]
        return {"train_accuracy": acc, "save_s": t_save, "load_s": t_load, "transform_after_load_s": t_tr2}, checks

    yr = regression_label(X, seed)

    def regressor_checks(model, out):
        pr = out.column("prediction")
        r2 = float(1.0 - ((pr - yr) ** 2).mean() / yr.var())
        return {"train_r2": r2}, [(np.isfinite(pr).all() and r2 > 0.5, f"GBTRegressor training R^2 {r2} <= 0.5")]

    run("gbt_classifier", GBTClassifier(**kw), y, classifier_checks)
    run("gbt_regressor", GBTRegressor(**kw), yr, regressor_checks)
    return by_path


def phase_gbt_subset(torch, X_host, y_host, seed, rows):
    """The same GBT fitted on the card and on the CPU (plain versions):
    no draws, and K5 adds in row order as the CPU does, but the gradient
    stats are real valued, so the card's other rounding (sigmoid, per-node
    sums) may move a near-tied split. Counts the differing nodes and the
    largest margin difference, and holds the predictions to GBT_AGREE_MIN
    agreement."""
    from spark_rapids_ml_tpu_torch import DataFrame, GBTClassifier
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    _rf_counts(rk, zero=True)
    fits, secs, outs = {}, {}, {}
    for dev in ("cuda:0", "cpu"):
        est = GBTClassifier(maxIter=GBT_SUBSET_ROUNDS, maxDepth=GBT_DEPTH, maxBins=RF_BINS, seed=seed, device=dev)
        fits[dev], secs[dev] = _timed(torch, lambda: est.fit(df))
        outs[dev] = fits[dev].transform(df)
    counts = _rf_counts(rk)
    a, b = fits["cuda:0"]._model_attributes, fits["cpu"]._model_attributes
    differ = int(((a["features"] != b["features"]) | (a["threshold_bins"] != b["threshold_bins"])).sum())
    margin_diff = float(np.abs(outs["cuda:0"].column("rawPrediction")[:, 1]
                               - outs["cpu"].column("rawPrediction")[:, 1]).max())
    agree = float((outs["cuda:0"].column("prediction") == outs["cpu"].column("prediction")).mean())
    emit({"phase": "subset", "estimator": "GBTClassifier", "rows": rows, "maxIter": GBT_SUBSET_ROUNDS,
          "maxDepth": GBT_DEPTH, "nodes_differ": differ, "max_margin_diff": margin_diff,
          "leaf_values_max_diff": float(np.abs(a["leaf_values"] - b["leaf_values"]).max()),
          "prediction_agreement": agree, "agreement_min": GBT_AGREE_MIN, "fit_s_card": secs["cuda:0"],
          "fit_s_cpu": secs["cpu"], "fit_report_card": fits["cuda:0"]._fit_report, "launches": counts})
    check(agree >= GBT_AGREE_MIN, f"GBT card vs CPU predictions agree on {agree} < {GBT_AGREE_MIN}")
    for name in ("node_hist_batched", "packed_forest_eval"):
        check(counts[name] > 0, f"kernel {name} was not launched on the GBT card-vs-CPU path")
    return counts


def phase_rf_profile(torch, X_host, y_host, seed):
    """One tree batch (8 trees) of the bench forest fitted again under
    ``torch.profiler``: the device time of every kernel and copy against
    the fit's wall clock (the device's busy share; the profiler adds host
    overhead, so the share is a lower bound), and the largest device-time
    kernels and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier

    df = DataFrame({"features": X_host[:RF_ROWS], "label": y_host[:RF_ROWS]})
    est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_DEPTH, maxBins=RF_BINS, seed=seed)
    plain_model, t_plain = _timed(torch, lambda: est.fit(df))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = _timed(torch, lambda: est.fit(df))
    # device-side events only (kernels, copies, sets): an operator's entry
    # carries the device time of the kernels it launched again
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            ops.append((us, e.key, e.count))
    ops.sort(reverse=True)
    device_s = sum(us for us, _, _ in ops) / 1e6
    emit({"phase": "e2e", "check": "rf_profile", "numTrees": RF_SMALL_TREES, "maxDepth": RF_DEPTH, "rows": RF_ROWS,
          "fit_s": t_plain, "fit_report": plain_model._fit_report, "profiled_fit_s": t_prof,
          "device_s": device_s if ops else "not measured",
          "device_busy_share": device_s / t_prof if ops else "not measured",
          "top_device_ops": [{"op": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in ops[:12]]})


def phase_rf_subset(torch, X_host, y_host, seed, rows):
    """The same forest fitted on the card and on the CPU (plain versions),
    with the same draws (a CPU generator on either side) and exact integer
    histograms: the trees are expected to be equal. Counts the differing
    nodes and holds the predictions to RF_AGREE_MIN agreement."""
    from spark_rapids_ml_tpu_torch import DataFrame, RandomForestClassifier
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk

    df = DataFrame({"features": X_host[:rows], "label": y_host[:rows]})
    _rf_counts(rk, zero=True)
    fits, secs, preds = {}, {}, {}
    for dev in ("cuda:0", "cpu"):
        est = RandomForestClassifier(numTrees=RF_SMALL_TREES, maxDepth=RF_SUBSET_DEPTH, maxBins=RF_BINS,
                                     seed=seed, device=dev)
        fits[dev], secs[dev] = _timed(torch, lambda: est.fit(df))
        preds[dev] = fits[dev].transform(df).column("prediction")
    counts = _rf_counts(rk)
    a, b = fits["cuda:0"]._model_attributes, fits["cpu"]._model_attributes
    differ = int(((a["features"] != b["features"]) | (a["threshold_bins"] != b["threshold_bins"])).sum())
    leaf_differ = int((a["leaf_stats"] != b["leaf_stats"]).any(axis=2).sum())
    agree = float((preds["cuda:0"] == preds["cpu"]).mean())
    emit({"phase": "subset", "estimator": "RandomForestClassifier", "rows": rows, "numTrees": RF_SMALL_TREES,
          "maxDepth": RF_SUBSET_DEPTH, "nodes_differ": differ, "leaf_stats_differ": leaf_differ,
          "gains_equal": bool(np.array_equal(a["gains"], b["gains"])), "prediction_agreement": agree,
          "agreement_min": RF_AGREE_MIN, "fit_s_card": secs["cuda:0"], "fit_s_cpu": secs["cpu"],
          "launches": counts})
    check(agree >= RF_AGREE_MIN, f"forest card vs CPU predictions agree on {agree} < {RF_AGREE_MIN}")
    for name in ("node_hist_batched", "packed_forest_eval"):
        check(counts[name] > 0, f"kernel {name} was not launched on the card-vs-CPU path")
    return counts


def host_parts(torch, rk, packed, idx, calls=2000):
    """Host µs per call of each step of a wrapper's host path, alone."""
    dev = idx.device
    steps = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "check_cuda": lambda: rk._check_cuda("k", (packed, torch.int32), (idx, torch.int32)),
        "empty_like": lambda: torch.empty_like(idx),
        "empty": lambda: torch.empty(idx.shape, dtype=torch.int32, device=dev),
        "data_ptr_x2": lambda: (packed.data_ptr(), idx.data_ptr()),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    }
    if hasattr(rk, "gather_geometry"):  # the routed package (see check_byte_gather)
        # the ctypes call alone: a plan of 0 rows returns at once
        launch = rk._build.function("rf_byte_gather", "packed_byte_gather_launch", [ctypes.c_void_p] * 5)
        plan, at = rk._gather_plan(0, 1, 1, 1, rk.GatherGeometry("direct_vec", 4, 0, 1, 0))
        steps["ctypes_call"] = lambda: launch(packed.data_ptr(), idx.data_ptr(), idx.data_ptr(), at, 0)
        steps["route_lookup"] = lambda: rk.gather_geometry(packed, idx)
    out = {}
    for name, step in steps.items():
        step()
        t = time.perf_counter()
        for _ in range(calls):
            step()
        out[name] = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return out


def gather_probe(torch, args, dev) -> int:
    """``--gather-only``: K7/K8's kernel phase alone, on 131,072 rows made
    from ``--seed`` (binned as the forest phase bins them) and 131,072
    3,000-feature rows, and the host cost of the wrapper's steps."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    X, _ = make_data(torch, RF_ROWS, RF_ROWS, args.seed, dev)
    bins = rf_bins(torch, pt, X, args.seed)
    del X
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 7)
    res = phase_byte_gather_kernels(torch, bins, wide_bins(torch, pt, RF_ROWS, g, args.seed), args.reps, args.seed,
                                    sweep=args.sweep)
    packed = pt.pack_bins(bins)
    idx = torch.zeros((8, RF_ROWS, 1), dtype=torch.int32, device=dev)
    emit({"probe": "byte_gather", "package": rk.__file__, "host_parts_us": host_parts(torch, rk, packed, idx),
          "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}})
    return 0


def knn_attributes(torch, kn) -> dict:
    """K4's registers, spill bytes a thread, resident blocks an SM and
    shared memory a block (the CUDA occupancy calculator), at the kNN,
    UMAP and k = 100 shapes."""
    out = {}
    for name, (nq, ni, k) in {"knn": (KNN_QUERIES, KNN_ITEMS, KNN_K), "join": (KNN_JOIN_QUERIES, KNN_ITEMS, KNN_K),
                              "umap_transform": (UMAP_ROWS, UMAP_ROWS, UMAP_NEIGHBORS),
                              "k100": (1037, 70_001, 100)}.items():
        g = kn.knn_geometry(nq, ni, E2E_D, k)
        a = kn._knn_attributes(g.bm, k, g.stages)
        out[name] = {"registers": a[0], "local_bytes": a[1], "blocks_per_sm": a[2], "smem": a[3]}
    return out


def sass_counts(name, mnemonics):
    """How many instructions of each mnemonic prefix the SASS of kernel
    library ``name`` holds (``cuobjdump`` beside ``nvcc``)."""
    import os
    import re

    from spark_rapids_ml_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {m: len(re.findall(r"\b" + re.escape(m), sass)) for m in mnemonics}


def sweep_knn(torch, kn, X):
    """K4 at the kNN and join shapes under other geometries (stage depth,
    item splits), and with a tight state (every row's k-th
    pair at -inf, so that no tile passes the gate and nothing is inserted:
    the product and the gate alone). Each variant's ids are compared with
    the routed geometry's."""
    dev = X.device
    out = []
    for name, nq in (("knn", KNN_QUERIES), ("join", KNN_JOIN_QUERIES)):
        Xq, ni, k = X[:nq], X.shape[0], KNN_K
        csq = (X * X).sum(dim=1)
        ids = torch.arange(ni, dtype=torch.int32, device=dev)
        st = (torch.full((nq, k), float("inf"), device=dev), torch.full((nq, k), -1, dtype=torch.int32, device=dev))
        base = kn.knn_geometry(nq, ni, E2E_D, k)
        ref_ids = kn._knn_topk_run(Xq, X, csq, ids, *st, base)[1]
        tight = (torch.full((nq, k), -float("inf"), device=dev), st[1])
        out.append({"shape": name, **base._asdict(), "tight_state": True,
                    "ms": cuda_ms(torch, lambda: kn._knn_topk_run(Xq, X, csq, ids, *tight, base), 1)})
        variants = [base._replace(stages=st_) for st_ in kn._STAGES if st_ != base.stages]
        if name == "join":
            variants += [kn._knn_geometry(nq, ni, E2E_D, k, splits=sp) for sp in (1, 2, 4, 16, 32)]
        for geo in variants:
            geo = geo._replace(smem=kn._knn_smem(geo.bm, geo.stages, k))
            if geo.smem > kn.SMEM_PER_BLOCK:
                continue
            topi = kn._knn_topk_run(Xq, X, csq, ids, *st, geo)[1]
            same = float((topi.sort(dim=1).values == ref_ids.sort(dim=1).values).all(dim=1).float().mean())
            out.append({"shape": name, **geo._asdict(), "rows_same_ids": same,
                        "ms": cuda_ms(torch, lambda: kn._knn_topk_run(Xq, X, csq, ids, *st, geo), 1)})
            emit({"probe": "knn_sweep", **out[-1]})
        del ref_ids
    return out


def knn_probe(torch, args, dev) -> int:
    """``--knn-only``: K4's kernel phase alone (all four shapes, ragged
    shapes and controls) on 1M rows made from ``--seed``, with the kernel's
    attributes and its gates' verdicts (reported, not enforced: the probe
    also measures older kernels); ``--sweep`` adds other geometries."""
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    X, _ = make_data(torch, KNN_ITEMS, KNN_ITEMS, args.seed, dev)
    attrs = knn_attributes(torch, kn)
    # the products' instructions: tensor-core TF32 (wgmma or mma.sync), or FP32 FMA
    sass = sass_counts("knn_topk", ("HGMMA.64x128x8.F32.TF32", "HMMA", "FFMA", "UTMALDG"))
    emit({"probe": "knn_topk", "attributes": attrs, "sass": sass})
    res = phase_knn_kernels(torch, X, make_umap_data(UMAP_ROWS, args.seed), args.reps, args.seed)
    out = {"probe": "knn_topk", "package": kn.__file__, "attributes": attrs, "sass": sass, "gates": knn_gates(res),
           "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}}
    if args.sweep:
        out["sweep"] = sweep_knn(torch, kn, X)
    emit(out)
    return 0


def sweep_lloyd(torch, kk, X, seed, reps):
    """K2 at k = 1024 and k = 4,097 with every row weight 1 and with every
    row weight 0 (an m = 0 row adds nothing to the sums or counts, so the
    second call times the product, the argmin and the row walk without the
    atomics), and at the other stage depths. Each depth's counts are
    compared with the routed launch's."""
    dev = X.device
    n = X.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    out = []
    for k in (E2E_CENTRES, 4097):
        C = X[torch.randint(0, n, (k,), generator=g, device=dev)].contiguous()
        base = kk.lloyd_geometry(n, k, E2E_D)
        row = {"k": k, **base._asdict(), "ms": cuda_ms(torch, lambda: kk.lloyd_step(X, ones, C), reps),
               "m0_ms": cuda_ms(torch, lambda: kk.lloyd_step(X, zeros, C), reps)}
        row["atomics_share"] = 1.0 - row["m0_ms"] / row["ms"]
        out.append(row)
        emit({"probe": "lloyd_sweep", **row})
        ref = kk.lloyd_step(X, ones, C)[1]
        for stages in kk._STAGES:
            if stages == base.stages:
                continue
            geo = kk._lloyd_geometry(n, k, E2E_D, sms=base.grid, stages=stages)
            same = bool(torch.equal(kk._lloyd_run(X, ones, C, geo)[1], ref))
            out.append({"k": k, **geo._asdict(), "counts_equal_routed": same,
                        "ms": cuda_ms(torch, lambda: kk._lloyd_run(X, ones, C, geo), reps)})
            emit({"probe": "lloyd_sweep", **out[-1]})
    return out


def lloyd_attributes(torch, kk) -> dict:
    """K2's registers, spill bytes a thread, resident blocks an SM and
    shared memory a block (the CUDA occupancy calculator) at each stage
    depth, and its launch at the main path's two shapes."""
    out = {f"stages_{s}": dict(zip(("registers", "local_bytes", "blocks_per_sm", "smem"), kk._lloyd_attributes(s)))
           for s in kk._STAGES}
    for k in (E2E_CENTRES, 4097):
        out[f"geometry_k{k}"] = kk.lloyd_geometry(12_000_000, k, E2E_D)._asdict()
    return out


def kmeans_probe(torch, args, dev) -> int:
    """``--kmeans-only``: K2's kernel phase alone (k = 1024 and 4,097 with
    their controls, the ragged shapes) on ``--rows`` rows made from
    ``--seed``, with the kernel's attributes, SASS instruction counts and
    its gates' verdicts (reported, not enforced); ``--sweep`` adds the m =
    0 split and the other stage depths."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk

    X, _ = make_data(torch, args.rows, args.rows, args.seed, dev)
    attrs = lloyd_attributes(torch, kk)
    # the products' instructions (tensor-core TF32, or FP32 FMA), the tensor
    # copies, the accumulation's atomics, and local (spill) stores and loads
    sass = sass_counts("lloyd_step", ("HGMMA.64x128x8.F32.TF32", "FFMA", "UTMALDG", "RED", "ATOM", "STL", "LDL"))
    emit({"probe": "lloyd_step", "attributes": attrs, "sass": sass})
    res = phase_lloyd_kernels(torch, X, args.reps, args.seed)
    out = {"probe": "lloyd_step", "package": kk.__file__, "attributes": attrs, "sass": sass,
           "gates": lloyd_gates(res),
           "ms_max": LLOYD_MS_MAX,
           "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}}
    if args.sweep:
        out["sweep"] = sweep_lloyd(torch, kk, X, args.seed, args.reps)
    emit(out)
    return 0


def hist_levels(sweep):
    """(name, level, trees, k, depth, stats) of the levels ``--hist-only``
    times: the GBT's level 7 (one tree, all 256 features, S = 4) and the
    bench forest's level 12 (8 trees, k = 16, S = 2); ``sweep`` adds the
    GBT's levels 0 and 3."""
    out = [("gbt_level7", GBT_DEPTH - 1, 1, E2E_D, GBT_DEPTH, "logit"),
           ("bench_level12", 12, 8, 16, RF_DEPTH, "cls")]
    if sweep:
        out += [("gbt_level0", 0, 1, E2E_D, GBT_DEPTH, "logit"), ("gbt_level3", 3, 1, E2E_D, GBT_DEPTH, "logit")]
    return out


def sweep_node_hist(torch, rk, inps, reps):
    """K5 per node at each probed level with parts of its span kernel
    knocked out (the walk, the row loads, the write: outputs that are not
    K5's, timed only), and at other span and stage sizes (SPAN_ROWS, which
    orders the sums otherwise than the builder; the bytes a stage of rows
    holds at 128 pairs a block)."""
    from spark_rapids_ml_tpu_torch.ops import _build

    fn = _build.function("rf_hist", "node_hist_launch", [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    base = (rk.SPAN_ROWS, rk._NH_STAGE_BYTES)
    runs = [(base, skip) for skip in (0, 1, 2, 3, 4, 7)]
    runs += [((span, stage), 0) for span in (2048, 4096, 8192) for stage in (2048, 4096, 8192) if (span, stage) != base]
    out = []
    try:
        for (span, stage), skip in runs:
            rk.SPAN_ROWS, rk._NH_STAGE_BYTES = span, stage
            row = {"skip": skip, "span_rows": span, "stage_bytes": stage}
            for name, inp in inps.items():
                a = node_hist_args(inp)
                row[name] = cuda_ms(torch, lambda: rk._node_hist_run(*a, inp["nb"], inp["r_sub"], fn, stream, skip),
                                    reps)
            out.append(row)
            emit({"probe": "node_hist_sweep", **row})
    finally:
        rk.SPAN_ROWS, rk._NH_STAGE_BYTES = base
    return out


def sweep_node_hist_sel(torch, rk, inp, reps):
    """K6 per node at one level with parts of its span kernel knocked out
    (the walk, the row loads, the write: outputs that are not K6's, timed
    only), at other stage sizes (the bytes a stage of rows holds at 128
    pairs a block), and with twice the span partials' bound (fewer slot
    chunks where the bound chunks them)."""
    a = node_hist_args(inp)
    fn, stream = rk._sel_launch(), torch.cuda.current_stream().cuda_stream
    base = (rk._NH_STAGE_BYTES, rk._NH_SCRATCH_MAX)
    runs = [(base, skip) for skip in (0, 1, 2, 4, 7)]
    runs += [((stage, base[1]), 0) for stage in (2048, 8192, 16384)] + [((base[0], 2 * base[1]), 0)]
    out = []
    try:
        for (stage, scratch), skip in runs:
            rk._NH_STAGE_BYTES, rk._NH_SCRATCH_MAX = stage, scratch
            out.append({"stage_bytes": stage, "scratch_max": scratch, "skip": skip, "ms": cuda_ms(
                torch, lambda: rk._node_hist_sel_run(*a, inp["feats"], inp["nb"], inp["r_sub"], fn, stream, skip),
                reps)})
    finally:
        rk._NH_STAGE_BYTES, rk._NH_SCRATCH_MAX = base
    return out


def hist_probe(torch, args, dev) -> int:
    """``--hist-only``: K5's and K6's levels alone on rows made from
    ``--seed``, each timed by CUDA events. K5 at the GBT's level 7 and the
    bench forest's level 12 on the forest rows: one whole K5-route level of
    ``_hist_compact_batched`` (layout, gathers, the kernel) and one launch
    of K5 per node (held with its controls, its span kernel's registers,
    spills and resident blocks at the level's geometry), then the ragged K5
    cases. K6 at its three timed shapes (``sel_inputs``), held with its
    controls and timed beside route B and its library calls, and one whole
    wide-route level of ``_hist_compact_batched``; then the ragged K6
    cases. ``--sweep`` adds the GBT's levels 0 and 3 and ``sweep_node_hist``,
    and ``sweep_node_hist_sel`` at K6's three shapes."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    X, y = make_data(torch, RF_ROWS, RF_ROWS, args.seed, dev)
    bins = rf_bins(torch, pt, X, args.seed)
    del X
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 7)
    cls = torch.nn.functional.one_hot(y.long(), 2).float()
    stats = {"logit": gbt_level_stats(torch, y, g), "cls": cls}
    reps = max(args.reps, 10)
    out = {"probe": "node_hist", "package": rk.__file__, "levels": {}}
    kept = {}
    for name, level, T, k, depth, kind in hist_levels(args.sweep):
        inp = rf_level_inputs(torch, pt, bins, stats[kind], level, T, k, E2E_D, g, depth=depth,
                              bootstrap=kind == "cls")
        S, nb, r_sub, n_pad, n_nodes = inp["S"], inp["nb"], inp["r_sub"], inp["n_pad"], inp["n_nodes"]
        row = {"level": level, "T": T, "F": inp["hist_src"].shape[-1], "S": S, "n_pad": n_pad, "r_sub": r_sub}
        row["route_ms"] = cuda_ms(torch, lambda: pt._hist_compact_batched(
            inp["hist_src"], inp["seg"], inp["sw_rows"], n_nodes=n_nodes, nb=nb, r_sub=r_sub, n_pad=n_pad), reps)
        gbt = kind == "logit"
        row["node_hist"] = check_node_hist(torch, rk, inp, reps, exact=not gbt, control=True, cpu_bitwise=gbt,
                                           fold_control=gbt and level == 0)
        emit({"probe": "node_hist", "shape": name, **row})
        out["levels"][name] = row
        if args.sweep and name != "gbt_level3":
            kept[name] = inp
        del inp
        torch.cuda.empty_cache()
    if args.sweep:
        out["sweep"] = sweep_node_hist(torch, rk, kept, reps)
    del kept
    ragged_node_hist_checks(torch, rk, pt, g)
    wide = wide_bins(torch, pt, RF_ROWS, g, args.seed)
    for key, shape, inp in sel_inputs(torch, pt, wide, cls, g):
        row = {"node_hist_sel": check_node_hist(torch, rk, inp, reps, control=True)}
        row["route_ms"] = cuda_ms(torch, lambda: pt._hist_compact_batched(
            None, inp["seg"], inp["sw_rows"], n_nodes=inp["n_nodes"], nb=inp["nb"], r_sub=inp["r_sub"],
            n_pad=inp["n_pad"], full_bins=inp["hist_src"], feats=inp["feats"]), reps)
        if args.sweep:
            row["sweep"] = sweep_node_hist_sel(torch, rk, inp, reps)
        emit({"probe": "node_hist_sel", "shape": shape, **row})
        out["levels"][shape] = row
        del inp
        torch.cuda.empty_cache()
    del wide
    ragged_node_hist_sel_checks(torch, rk, pt, g)
    emit(out)
    return 0


def k3_inputs(torch, n, d, K, seed, dev):
    """(X, y, m, A, b) of a K3 pass: Gaussian rows, 10% of them masked,
    labels in [0, max(K, 2)), A and b small, made on the card from ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn(n, d, generator=g, device=dev)
    m = (torch.rand(n, generator=g, device=dev) > 0.1).float()
    y = torch.randint(0, max(K, 2), (n,), generator=g, device=dev).float()
    A = torch.randn(K, d, generator=g, device=dev) * 0.05
    b = torch.randn(K, generator=g, device=dev) * 0.1
    return X, y, m, A, b


def logreg_probe(torch, args, dev) -> int:
    """``--logreg-only``: K3 alone at the shapes of K3_PROBE_SHAPES (the
    class-tiled instance's four timed shapes, the route's five, the
    cluster kernel's four, the shape the general kernel keeps, and the
    tile kernel's <1, 8> and <1, 16> instances), each held against its f64
    plain version (``check_logreg``, with its controls) and timed by CUDA
    events as the whole call, its first kernel (the route: its two
    kernels; its logits kernel alone too) and its second pass alone, for
    the routed kernel and, where that is another, for the general kernel
    forced by its code (but at K3_PROBE_GENERAL_SKIP), so that each kernel
    and the general kernel stand side by side in one call; with the
    kernels' registers, spills and resident blocks (the cluster kernel:
    its geometry and the clusters the card holds at once), then the ragged
    K3 shapes. ``--sweep`` adds the general kernel with its gradient
    stage's X re-read or its per-tile partial write knocked out, and the
    cluster kernel with its gradient's reads of the staged rows or its
    cluster exchange knocked out, and at every other cluster size that
    takes the shape (timed only: the knocked-out results are wrong)."""
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    reps = max(args.reps, 10)
    out = {"probe": "logreg", "package": lk.__file__, "shapes": {}, "failed": []}
    for n, d, K in K3_PROBE_SHAPES:
        key = f"n{n}_d{d}_K{K}"
        X, y, m, A, b = k3_inputs(torch, n, d, K, args.seed, dev)
        multinomial = K > 1
        try:  # a probe: a shape that fails its check is reported, and the next runs
            row = check_logreg(torch, lk, X, y, m, K, reps, args.seed, control=True, strict=True)
        except SystemExit as e:
            out["failed"].append(f"{key}: {e}")
            emit({"probe": "logreg", "shape": key, "failed": str(e)})
            row = {}
        routed = lk._k3_variant(d, K, multinomial)
        y_k = y if multinomial else (y > 0).float()
        general = routed and (n, d, K) not in K3_PROBE_GENERAL_SKIP
        for name, variant in (("routed", routed),) + ((("general", 0),) if general else ()):
            # the general kernel past 1e11 (row, feature, class) triples: ~4 s a call, 3 calls a time
            r_reps = 3 if variant == 0 and n * d * K > 1e11 else reps

            def run(knock=0):
                return lk._logreg_run(X, y_k, m, A, b, multinomial, variant, knock)

            if 1000 <= variant < 3000:  # the routed launch's resident blocks must fit
                geo = lk._tile_geometry(n, d, K, multinomial)
                fits = lk._logreg_attributes(variant, geo.smem)[2]
                if fits < geo.blocks_per_sm:
                    out["failed"].append(f"{key}: {fits} resident blocks an SM, {geo.blocks_per_sm} planned")
            r = {"variant": variant, "whole_ms": cuda_ms(torch, run, r_reps),
                 "first_kernel_ms": cuda_ms(torch, lambda: run(1), r_reps),
                 "second_pass_ms": cuda_ms(torch, lambda: run(2), r_reps),
                 "attributes": lk_attributes(lk, variant, n, d, K, multinomial)}
            if variant >= 3000:  # the logits kernel (and the operands' split) alone
                r["logits_kernel_ms"] = cuda_ms(torch, lambda: run(1 | 16), reps)
            if args.sweep and variant == 0:
                for what, knock in (("no_x_reread", 4), ("no_tile_write", 8), ("neither", 12)):
                    r[f"first_kernel_{what}_ms"] = cuda_ms(torch, lambda: run(1 | knock), reps)
            if args.sweep and variant >= lk._CLUSTER:
                for what, knock in (("no_x_reads", 4), ("no_exchange", 64), ("neither", 68)):
                    r[f"first_kernel_{what}_ms"] = cuda_ms(torch, lambda: run(1 | knock), reps)
                for c in lk._CLUSTER_SIZES:  # the other cluster sizes that take the shape
                    geo = lk._cluster_geometry(n, d, C=c)
                    if geo is not None and geo.C != r["attributes"]["geometry"]["C"]:
                        r[f"C{c}_ms"] = cuda_ms(torch, lambda: lk._cluster_run(X, y_k, m, A, b, variant, 0, geo), reps)
            row[name] = r
        emit({"probe": "logreg", "shape": key, **{k: v for k, v in row.items() if k != "controls"}})
        out["shapes"][key] = row
        del X, y, m, A, b, y_k
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 1)
    try:
        ragged_logreg_checks(torch, lk, g, args.seed)
    except SystemExit as e:
        out["failed"].append(f"ragged: {e}")
    emit(out)
    return 1 if out["failed"] else 0


def lk_attributes(lk, variant, n, d, K, multinomial) -> dict:
    """Registers, spill bytes, resident blocks an SM and shared memory of
    K3's first kernel ``variant`` at this shape (the route: of each of its
    two kernels), and of its second pass."""
    keys = ("registers", "local_bytes", "blocks_per_sm", "smem")
    out = {"second_pass": dict(zip(keys, lk._logreg_attributes(-1, 0)))}
    if variant >= lk._CLUSTER:  # its instance at d (aligned X), and the clusters the card holds at once
        geo, vec = lk._cluster_geometry(n, d), d % 4 == 0
        out["first"] = dict(zip(keys, lk._logreg_attributes(variant + (0 if vec else 100), geo.smem)))
        out["geometry"] = geo._asdict()
        out["active_clusters"] = lk._cluster_active(0, vec, geo.C, geo.smem)
        return out
    if variant >= 3000:
        geo = lk._route_geometry(n, d, K)
        out["logits"] = dict(zip(keys, lk._logreg_attributes(variant, geo.smem)))
        out["gradient"] = dict(zip(keys, lk._logreg_attributes(variant + 1000, geo.smem)))
        out["geometry"] = geo._asdict()
        return out
    rt = min(lk._LOGREG_TILE_ROWS, lk._LOGREG_SMEM // (4 * K))
    smem = 4 * rt * K if variant == 0 else lk._tile_geometry(n, d, K, multinomial).smem if variant >= 1000 else 0
    out["first"] = dict(zip(keys, lk._logreg_attributes(variant, smem)))
    if variant >= 1000:
        out["geometry"] = lk._tile_geometry(n, d, K, multinomial)._asdict()
    return out


def umap_paths(torch, X_umap, X_cluster, seed) -> dict:
    """The two UMAP paths, each with the launch counters zeroed just before
    it and read just after: ``{path: {kernel: launches}}``. umap: 65,536 x
    256 with its 20,000-row card-vs-CPU fits; umap_cluster: 70,000 x 784,
    10 components, with its 10,000-row card-vs-CPU fit (random init)."""
    cluster = {"n_neighbors": CLUSTER_NEIGHBORS, "min_dist": CLUSTER_MIN_DIST, "n_components": CLUSTER_COMPONENTS}
    out = {"umap": phase_umap_e2e(torch, X_umap, seed)}
    phase_umap_subset(torch, X_umap, seed, UMAP_SUBSET)
    out["umap_cluster"] = phase_umap_e2e(torch, X_cluster, seed, path="umap_cluster", save=False, **cluster)
    phase_umap_subset(torch, X_cluster, seed, CLUSTER_SUBSET, inits=("random",), **cluster)
    return out


def k10_entries(kern, by_path) -> list:
    """The ``kernels``-line entries of K10: its STEP epilogue's instance
    for C = 2 at the umap fit shape (the umap path's launches), its
    generic instance at the umap_cluster shape (C = 10: that path's
    launches), the C = 2 instance at the umap_ivf fit's and transform's
    own shapes (that path's launches at each) and its ROWS epilogue at the
    umap fit shape (no path launches it). The umap and umap_cluster
    transform shapes' numbers are in ``extra_shapes``."""
    step = by_path["sgd_epoch_step"]
    ivf_fit, ivf_tr = kern["sgd_epoch_umap_ivf"], kern["sgd_epoch_umap_ivf_transform"]
    rows = [("umap_sgd_epoch", "sgd_epoch", "", {p: step[p] for p in ("umap",) if p in step}),
            ("umap_sgd_epoch_generic", "sgd_epoch_cluster", "", {p: step[p] for p in ("umap_cluster",) if p in step}),
            ("umap_sgd_epoch_ivf", "sgd_epoch_umap_ivf", "", {"umap_ivf": ivf_fit["launches"]}),
            ("umap_sgd_epoch_ivf_transform", "sgd_epoch_umap_ivf_transform", "", {"umap_ivf": ivf_tr["launches"]}),
            ("umap_sgd_epoch_rows", "sgd_epoch", "rows_", {})]
    check(ivf_fit["launches"] + ivf_tr["launches"] == step.get("umap_ivf"),
          f"K10's umap_ivf launches at its two shapes {ivf_fit['launches']} + {ivf_tr['launches']}, of the path "
          f"{step.get('umap_ivf')}")
    out = []
    for name, key, pre, paths in rows:
        r = kern[key]
        out.append({
            "name": name, "route": "cuda", "source": "spark_rapids_ml_tpu_torch/csrc/umap_sgd_epoch.cu",
            "replaces": "spark_rapids_ml_tpu/ops/umap_pallas.py:277", "epilogue": "ROWS" if pre else "STEP",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": r[pre + "max_abs_err"], "ms": r[pre + "ms"], "plain_ms": r[pre + "plain_ms"],
            "bound_ms": r[pre + "bound_ms"], "bound_by": r[pre + "bound_by"], "library_ms": r[pre + "library_ms"],
            "shape": {k: r[k] for k in ("R", "K", "C", "neg", "n_tab", "n_head", "rows_live", "active_slots")}})
    return out


# the ANN workload of bench.py (bench.py:1205-1252): 131,072 x 256 items
# from 64 blobs (centre scale 4, unit noise), its first 65,536 rows the
# queries, k = 16; at 131,072 items the default index has nlist = 362 and
# nprobe = 46, and the ANN gate (131,072 items) routes it to the IVF engine
ANN_ROWS = 131_072
ANN_QUERIES = 65_536
ANN_K = 16
ANN_BLOBS = 64
ANN_NLIST, ANN_NPROBE = 362, 46
# recall@k against K4's exact answer on this many queries, and its floor
# (the JAX package's target, tests/test_ann.py:57)
ANN_RECALL_QUERIES = 4096
ANN_RECALL_MIN = 0.95
# queries of the scan at nprobe = nlist (362 probes a query chunk)
ANN_FULL_PROBE_QUERIES = 1024
# the negative control: this many items lie below the gate and must be
# answered by the exact search
ANN_CONTROL_ROWS = 65_536
# the umap_ivf path: UMAP(n_neighbors=15) on 131,072 rows of the umap
# path's 32 blobs, where the default graph engine is IVF
UMAP_IVF_ROWS = 131_072
UMAP_IVF_EPOCHS = 200  # the default epochs from 10,000 rows
# rows its transform embeds, its first quarter: a transform of all 131,072
# rows repeats the fit graph's probe scan (11.4 s on an H100 80GB HBM3 at
# 700 W) and would take the two IVF paths past 40 s
UMAP_IVF_TRANSFORM_ROWS = 32_768


def make_ann_data(seed: int) -> np.ndarray:
    """(131,072, 256) f32 host rows: 64 Gaussian blobs (centre scale 4,
    unit noise), the recipe of ``bench.py``'s ANN entry (its seed 11 at
    ``--seed 0``)."""
    rng = np.random.default_rng(seed + 11)
    centers = rng.normal(size=(ANN_BLOBS, E2E_D)).astype(np.float32) * 4.0
    lab = rng.integers(0, ANN_BLOBS, size=ANN_ROWS)
    return (centers[lab] + rng.normal(size=(ANN_ROWS, E2E_D))).astype(np.float32)


def ivf_counters(zero=False) -> dict:
    """The launch counts of the kernels the IVF paths may run: K2 (the
    coarse quantizer), K4 (the exact search) and K10 (UMAP's epochs, both
    epilogues); ``zero`` sets them to 0 first."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    fns = {"lloyd_step": kk.lloyd_step, "knn_topk": kn.knn_topk_pass, "sgd_epoch_step": uk.sgd_epoch_step,
           "sgd_epoch_rows": uk.sgd_epoch_rows}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def phase_ivf_quantizer_k2(torch, X_host, seed):
    """K2 at the IVF coarse quantizer's shape: the build's Lloyd runs on
    all 131,072 x 256 items (fewer than its 2^18-row sample) against nlist
    = 362 centres, here 362 items drawn from ``seed``; held with its
    controls and timed as a median device time beside its plain version
    and one matmul + argmin + ``index_add_``, with its bound."""
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as kk

    dev = torch.device("cuda:0")
    X = torch.from_numpy(X_host).to(dev)
    pick = np.random.default_rng(seed + 12).choice(X.shape[0], ANN_NLIST, replace=False)
    C = X[torch.from_numpy(pick).to(dev)].contiguous()
    r = check_lloyd_step(torch, kk, X, torch.ones(X.shape[0], device=dev), C, STREAM_K2_REPS, control=True,
                         timer=median_device_ms)
    emit({"phase": "kernels", "kernel": "lloyd_step", "shape": "lloyd_step_ivf_quantizer",
          **{key: v for key, v in r.items() if key != "controls"},
          "controls": [(c["control"], c["err_over_tol"]) for c in r["controls"]]})
    del X, C
    torch.cuda.empty_cache()
    return r


def set_recall(torch, got, want) -> float:
    """Mean over rows of |got ∩ want| / k for (rows, k) id tensors."""
    return float((got[:, :, None] == want[:, None, :]).any(dim=2).float().mean())


def scan_split(torch, ik, xq, index, k, nprobe, reps=3) -> dict:
    """Device ms (``cuda_ms``) of one query chunk's probe scan (``xq``:
    its qc rows): whole (``ivf_search``), its ``nprobe`` window gathers
    alone and its ``nprobe`` ``bmm`` alone; the rest is the coarse step,
    the clamps and the selections. With the gather's rate (each (qc, cap,
    d) tile read once and written once) and the ``bmm``'s (each tile read
    once)."""
    cap, d = index.cap, xq.shape[1]
    gx3 = index.grouped_x.view(-1, cap, d)
    cents = index.centroids
    probes = ik._stable_smallest(ik.pairwise_sq_dists(xq, cents, (cents * cents).sum(dim=1)), nprobe)
    xi = gx3[probes[:, 0]]

    def gathers():
        for j in range(nprobe):
            gx3[probes[:, j]]

    def bmms():
        for _ in range(nprobe):
            torch.bmm(xi, xq[:, :, None])

    whole = cuda_ms(torch, lambda: ik.ivf_search(xq, index, k=k, nprobe=nprobe), reps)
    gather, bmm = cuda_ms(torch, gathers, reps), cuda_ms(torch, bmms, reps)
    tiles = float(xq.shape[0]) * cap * d * 4 * nprobe
    return {"qc": xq.shape[0], "steps": nprobe, "whole_ms": whole, "gather_ms": gather, "bmm_ms": bmm,
            "rest_ms": whole - gather - bmm, "gather_tb_per_s": 2 * tiles / gather * 1e-9,
            "bmm_tb_per_s": tiles / bmm * 1e-9}


def phase_ann(torch, X_host):
    """ApproximateNearestNeighbors(k=16) at the default algoParams on the
    ANN workload, through DataFrame (the IVF engine: K2 in the build, the
    plain probe scan), with the launch counters zeroed just before
    ``kneighbors`` and read just after; then, outside the counted run:
    recall@16 against K4's exact answer on the first 4,096 queries (at
    least ANN_RECALL_MIN), the scan at nprobe = nlist on the first 1,024
    (the exact neighbours, held against an f64 reference up to near ties
    at the k-th distance), the bytes the scan's (qc, cap, d) tiles gathered
    per search second, one query chunk's scan split (``scan_split``), and
    the negative control: 65,536 items (below the
    gate) answered by the exact search, equal to NearestNeighbors bit for
    bit. Returns ``{path: {kernel: launches}}``."""
    from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, DataFrame, NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import ivf_kernels as ik
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    dev = torch.device("cuda:0")
    nq, k, nr = ANN_QUERIES, ANN_K, ANN_RECALL_QUERIES
    item_df = DataFrame({"features": X_host})
    query_df = DataFrame({"features": X_host[:nq]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ivf_counters(zero=True)
    model = ApproximateNearestNeighbors(k=k).fit(item_df)
    (_, _, knn_df), t = _timed(torch, lambda: model.kneighbors(query_df))
    launches = ivf_counters()
    peak = torch.cuda.max_memory_allocated()
    rep = model._ann_report
    check(rep["engine"] == "ivf" and (rep["nlist"], rep["nprobe"]) == (ANN_NLIST, ANN_NPROBE),
          f"ann: the engine report {rep}, not ivf at nlist {ANN_NLIST}, nprobe {ANN_NPROBE}")
    check(launches["lloyd_step"] > 0, f"ann: kernel lloyd_step was not launched by the index build: {launches}")
    check(launches["knn_topk"] == 0, f"ann: the IVF search launched the exact kernel: {launches}")
    idx = np.asarray(knn_df.column("indices"))
    dist = np.asarray(knn_df.column("distances"))
    check(idx.shape == (nq, k) and np.isfinite(dist).all() and (idx >= 0).all(), "ann: kneighbors shape, ids, finiteness")
    check(bool((np.diff(dist, axis=1) >= 0).all()), "ann: kneighbors distances not ascending")

    # the scan's gathered tiles: every query reads nprobe windows of cap rows
    index = next(iter(model._ivf_index_cache.values()))
    qc = ik._search_qchunk(index.cap, E2E_D)
    gathered = float(nq) * ANN_NPROBE * index.cap * E2E_D * 4
    Xq = torch.from_numpy(X_host[:nq]).to(dev)

    # recall@k against K4's exact answer (counted launches already read)
    Xi = torch.from_numpy(X_host).to(dev)
    ones, ar = torch.ones(Xi.shape[0], device=dev), torch.arange(Xi.shape[0], dtype=torch.int32, device=dev)
    _, exact = kn.knn_search(Xq[:nr], Xi, ones, ar, k)
    recall = set_recall(torch, torch.from_numpy(idx[:nr]).to(dev), exact)
    check(recall >= ANN_RECALL_MIN, f"ann: recall@{k} {recall} below {ANN_RECALL_MIN}")
    # every list scanned: the exact neighbours
    nf = min(ANN_FULL_PROBE_QUERIES, nr)
    (fd2, fids), t_full = _timed(torch, lambda: ik.ivf_search(Xq[:nf], index, k=k, nprobe=index.nlist))
    recall_full = set_recall(torch, fids, exact[:nf])
    ref_d2, ref_ids, tau = knn_reference(torch, kn, Xq[:nf], Xi, (Xi * Xi).sum(dim=1), ar, k)
    err, ratio, differ, near, outside = knn_held(torch, fd2, fids, ref_d2, ref_ids, tau)
    check(ratio <= 1.0 and outside == 0,
          f"ann: nprobe = nlist off the f64 exact answer: err/tau {ratio}, {outside} rows differ past a near tie")
    del Xi, exact, fd2, fids, ref_d2, ref_ids, tau
    split = scan_split(torch, ik, Xq[:qc], index, k, ANN_NPROBE)

    # the negative control: below the gate the exact search answers
    ctrl_items = DataFrame({"features": X_host[:ANN_CONTROL_ROWS]})
    ctrl_q = DataFrame({"features": X_host[:nr]})
    ivf_counters(zero=True)
    ann_c = ApproximateNearestNeighbors(k=k).fit(ctrl_items)
    (_, _, ck), t_ctrl = _timed(torch, lambda: ann_c.kneighbors(ctrl_q))
    ctrl_launches = ivf_counters()
    _, _, nk = NearestNeighbors(k=k).fit(ctrl_items).kneighbors(ctrl_q)
    same = all(np.array_equal(np.asarray(ck.column(c)), np.asarray(nk.column(c))) for c in ("indices", "distances"))
    check(ann_c._ann_report["engine"] == "exact" and ctrl_launches["lloyd_step"] == 0
          and ctrl_launches["knn_topk"] > 0 and same,
          f"ann: {ANN_CONTROL_ROWS} items: {ann_c._ann_report}, launches {ctrl_launches}, equal to "
          f"NearestNeighbors {same}")
    emit({"phase": "e2e", "estimator": "ApproximateNearestNeighbors", "path": "ann", "k": k, "items": ANN_ROWS,
          "queries": nq, "kneighbors_s": t, "queries_per_s": nq / t, **rep, "cap": index.cap,
          "lens_max": int(index.lens.max()), "lens_min": int(index.lens.min()),
          "hard_capacity": ik.hard_capacity(ANN_ROWS, ANN_NLIST), "qchunk": qc,
          "scan_steps": -(-nq // qc) * ANN_NPROBE, "gathered_bytes": gathered,
          "gathered_gb_per_search_s": gathered / rep["search_seconds"] * 1e-9, "scan_split": split,
          "peak_device_bytes": peak,
          "device_bytes_before": mem0, "recall": recall, "recall_queries": nr, "recall_min": ANN_RECALL_MIN,
          "nprobe_nlist_queries": nf, "nprobe_nlist_s": t_full, "recall_nprobe_nlist": recall_full,
          "nprobe_nlist_err_over_tau": ratio, "nprobe_nlist_rows_differ": differ, "nprobe_nlist_near_ties": near,
          "launches": launches, "control_items": ANN_CONTROL_ROWS, "control_engine": ann_c._ann_report["engine"],
          "control_s": t_ctrl, "control_launches": ctrl_launches, "control_equal_to_exact": same})
    return {"ann": launches, "ann_exact_control": ctrl_launches}


def phase_umap_ivf(torch, seed):
    """UMAP(n_neighbors=15, random_state=42) fit of 131,072 rows of the
    umap path's blobs, where the default graph engine is IVF, and transform
    of their first 32,768:
    K2 in each index build (the fit's, then the transform's over the frozen
    rows), no K4, K10 once an epoch (200 fit epochs and the refine
    epochs). The fit's kNN graph (recorded as the fit hands it to
    ``drop_self_column``) holds recall@15 against K4's exact graph on 4,096
    rows (at least ANN_RECALL_MIN), and the embeddings hold trustworthiness
    as the umap path does. Returns ``({kernel: launches}`` of the fit and
    transform, ``{"fit" | "transform": K10's inputs})``: the inputs each
    ``umap_sgd`` call of the path got (recorded as the model hands them
    over) and the launches it made, for ``phase_umap_ivf_sgd``."""
    from spark_rapids_ml_tpu_torch import DataFrame, UMAP
    from spark_rapids_ml_tpu_torch.models import umap as mumap
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kn

    dev = torch.device("cuda:0")
    k = UMAP_NEIGHBORS
    X = make_umap_data(UMAP_IVF_ROWS, seed)
    n = X.shape[0]
    df = DataFrame({"features": X})
    graphs, sgd_calls = [], []
    real, real_sgd = mumap.drop_self_column, mumap.umap_sgd

    def recording(dists, idx, *, k):
        out = real(dists, idx, k=k)
        graphs.append(out[1])
        return out

    def recording_sgd(emb, table, row_heads, tails, p, generator, **kw):
        sgd_calls.append({"n_tab": table.shape[0], "n_head": emb.shape[0], "C": emb.shape[1], "row_heads": row_heads,
                          "tails": tails, "p": p, "a": kw["a"], "b": kw["b"], "neg": kw["negative_sample_rate"],
                          "self_table": kw["self_table"]})
        return real_sgd(emb, table, row_heads, tails, p, generator, **kw)

    mumap.drop_self_column, mumap.umap_sgd = recording, recording_sgd
    nt = UMAP_IVF_TRANSFORM_ROWS
    try:
        ivf_counters(zero=True)
        model, t_fit = _timed(torch, lambda: UMAP(n_neighbors=k, random_state=42).fit(df))
        fit_launches = ivf_counters()
        out, t_tr = _timed(torch, lambda: model.transform(DataFrame({"features": X[:nt]})))
        launches = ivf_counters()
    finally:
        mumap.drop_self_column, mumap.umap_sgd = real, real_sgd
    rep = model._fit_report
    check(rep["graph_engine"] == "ivf" and (rep["ann_nlist"], rep["ann_nprobe"]) == (ANN_NLIST, ANN_NPROBE),
          f"umap_ivf: the fit's graph engine {rep}")
    refine = model._transform_report["refine_epochs"]
    check(model._transform_report["graph_engine"] == "ivf", f"umap_ivf: transform report {model._transform_report}")
    check(fit_launches["lloyd_step"] > 0 and launches["lloyd_step"] > fit_launches["lloyd_step"]
          and launches["knn_topk"] == 0, f"umap_ivf: K2 / K4 launches {fit_launches}, with the transform {launches}")
    check(fit_launches["sgd_epoch_step"] == rep["n_epochs"] == UMAP_IVF_EPOCHS
          and launches["sgd_epoch_step"] - fit_launches["sgd_epoch_step"] == refine and launches["sgd_epoch_rows"] == 0,
          f"umap_ivf: K10 launches {fit_launches} (fit, {rep['n_epochs']} epochs), {launches} (refine {refine})")
    emb, emb_t = model.embedding_, np.asarray(out.column("embedding"))
    check(emb.shape == (n, 2) and np.isfinite(emb).all() and emb_t.shape == (nt, 2) and np.isfinite(emb_t).all(),
          "umap_ivf: embedding shape or finiteness")
    trust_fit, trust_tr = _trust_sample(torch, X, emb, seed), _trust_sample(torch, X[:nt], emb_t, seed)
    check(trust_fit > TRUST_MIN and trust_tr > TRUST_MIN,
          f"umap_ivf: trustworthiness fit {trust_fit}, transform {trust_tr} not above {TRUST_MIN}")
    # the fit's graph against K4's exact graph (self dropped) on 4,096 rows
    Xd = torch.from_numpy(X).to(dev)
    rows = query_sample(torch, n, dev)
    _, ie = kn.knn_search(Xd[rows], Xd, torch.ones(n, device=dev), torch.arange(n, dtype=torch.int32, device=dev),
                          k + 1)
    self_mask = ie == rows[:, None].to(ie.dtype)
    drop = torch.where(self_mask.any(dim=1), self_mask.to(torch.int32).argmax(dim=1), k)
    cols = torch.arange(k, device=dev)[None, :]
    exact = ie.gather(1, cols + (cols >= drop[:, None]).long())
    recall = set_recall(torch, graphs[0][rows], exact)
    check(recall >= ANN_RECALL_MIN, f"umap_ivf: graph recall@{k} {recall} below {ANN_RECALL_MIN}")
    del Xd, ie, exact
    emit({"phase": "e2e", "estimator": "UMAP", "path": "umap_ivf", "n_neighbors": k, "rows": n, "fit_s": t_fit,
          "transform_rows": nt, "transform_s": t_tr, "graph_s": rep["graph_seconds"], "init_s": rep["init_seconds"],
          "sgd_s": rep["sgd_seconds"], "epoch_ms": rep["epoch_ms"], "n_epochs": rep["n_epochs"],
          "graph_engine": rep["graph_engine"], "ann_nlist": rep["ann_nlist"], "ann_nprobe": rep["ann_nprobe"],
          "transform_graph_engine": model._transform_report["graph_engine"], "refine_epochs": refine,
          "graph_recall": recall, "recall_rows": int(rows.numel()), "recall_min": ANN_RECALL_MIN,
          "trustworthiness_fit": trust_fit, "trustworthiness_transform": trust_tr, "trust_min": TRUST_MIN,
          "fit_launches": fit_launches, "launches": launches})
    check(len(sgd_calls) == 2 and sgd_calls[0]["self_table"] and not sgd_calls[1]["self_table"],
          f"umap_ivf: {len(sgd_calls)} umap_sgd calls, not the fit's and the transform's")
    sgd_calls[0]["launches"] = fit_launches["sgd_epoch_step"]
    sgd_calls[1]["launches"] = launches["sgd_epoch_step"] - fit_launches["sgd_epoch_step"]
    return launches, {"fit": sgd_calls[0], "transform": sgd_calls[1]}


def phase_umap_ivf_sgd(torch, calls, reps, seed) -> dict:
    """K10 at the umap_ivf path's two shapes, on the rows the path gave it
    (``calls``, from ``phase_umap_ivf``): the fit's CSR rows of the
    131,072-row IVF graph (K = 24, C = 2, neg = 5, the self table) and the
    transform's 32,768 rows of K = 15 neighbours into the frozen 131,072 x
    2 table, each on a random table, held with its controls and timed
    beside its plain version, with its bound. Returns ``{key: result}``,
    each with the launches the path made at its shape."""
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 107)
    res = {}
    for key, shape, salt in (("sgd_epoch_umap_ivf", "fit", 107), ("sgd_epoch_umap_ivf_transform", "transform", 108)):
        c = calls[shape]
        src = torch.rand((c["n_tab"], c["C"]), generator=g, device=dev) * 20.0 - 10.0
        emb = src if c["self_table"] else torch.rand((c["n_head"], c["C"]), generator=g, device=dev) * 20.0 - 10.0
        R, K = c["tails"].shape
        u = torch.rand((R, K), generator=g, device=dev)
        perm = torch.randperm(c["n_tab"], generator=g, device=dev, dtype=torch.int32)
        offs = torch.randint(0, R, (c["neg"],), generator=g, device=dev, dtype=torch.int32)
        res[key] = {**check_sgd_epoch(torch, uk, "umap_ivf_" + shape, src, emb, c["row_heads"], c["tails"], c["p"],
                                      perm, offs, u, c["a"], c["b"], reps, 2.0 if c["self_table"] else 1.0,
                                      seed + salt), "launches": c["launches"]}
        emit({"phase": "kernels", "kernel": "umap_sgd_epoch", **res[key]})
    torch.cuda.synchronize()
    return res


def ivf_paths(torch, X_ann, seed):
    """The ann and umap_ivf paths, each with the launch counters zeroed
    just before it and read just after: ``({path: {kernel: launches}},
    K10's inputs on the umap_ivf path)``."""
    out = phase_ann(torch, X_ann)
    out["umap_ivf"], k10_calls = phase_umap_ivf(torch, seed)
    return out, k10_calls


def ann_probe(torch, args, dev) -> int:
    """``--ann-only``: K2 at the quantizer's shape, then the ann and
    umap_ivf paths, then K10 at the umap_ivf path's shapes. Exits 1 if a
    check failed."""
    X_ann = make_ann_data(args.seed)
    r = phase_ivf_quantizer_k2(torch, X_ann, args.seed)
    t = time.perf_counter()
    launches, k10_calls = ivf_paths(torch, X_ann, args.seed)
    paths_s = time.perf_counter() - t
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "err_over_tol")
    k10 = phase_umap_ivf_sgd(torch, k10_calls, args.reps, args.seed)
    emit({"probe": "ann", "paths_s": paths_s, "launches_by_path": launches, "k2": {m: r[m] for m in keys},
          "k10": {name: {m: v[m] for m in keys + ("launches",)} for name, v in k10.items()}})
    return 0


def umap_probe(torch, args, dev) -> int:
    """``--umap-only``: K10's checks at its four shapes and the two UMAP
    paths; ``--sweep`` first times K10's STEP epilogue with parts of its
    work knocked out at the fit and umap_cluster shapes. Exits 1 if a check
    failed."""
    X_umap = make_umap_data(UMAP_ROWS, args.seed)
    X_cluster = make_cluster_data(torch, args.seed, dev)
    if args.sweep:  # first: the checks below stop at a failed gate
        emit({"probe": "umap", "sweep": sweep_sgd(torch, X_umap, X_cluster, args.seed, dev)})
    res = phase_sgd_kernels(torch, X_umap, X_cluster, args.reps, args.seed, dev)
    launches = umap_paths(torch, X_umap, X_cluster, args.seed)
    emit({"probe": "umap", "launches_by_path": launches,
          "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}})
    return 0


def sweep_sgd(torch, X_umap, X_cluster, seed, dev) -> dict:
    """K10's STEP epilogue (its draws) whole and with parts of its work
    knocked out (its terms; its powf; its negatives' perm reads; both; all
    but the launch), at the fit and umap_cluster shapes: device ms, mean of
    50."""
    from spark_rapids_ml_tpu_torch.ops import umap_kernels as uk

    out = {}
    for name, X, k, C in (("fit", X_umap, UMAP_NEIGHBORS, 2), ("umap_cluster", X_cluster, CLUSTER_NEIGHBORS,
                                                                CLUSTER_COMPONENTS)):
        _, row_heads, tails_pad, p_pad = umap_rows(torch, uk, torch.from_numpy(X).to(dev), k)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 5)
        n = X.shape[0]
        emb = torch.rand((n, C), generator=g, device=dev) * 20.0 - 10.0
        tails, p = torch.from_numpy(tails_pad).to(dev), torch.from_numpy(p_pad).to(dev)
        rows = uk.head_rows(torch.from_numpy(row_heads).to(dev), p, n, C)
        perm = torch.randperm(n, generator=g, device=dev, dtype=torch.int32)
        offs = torch.randint(0, tails.shape[0], (5,), generator=g, device=dev, dtype=torch.int32)
        nxt = torch.empty_like(emb)
        out[name] = {}
        for knock, what in ((0, "whole"), (1, "no_terms"), (2, "no_powf"), (4, "no_perm_reads"),
                            (6, "no_powf_no_perm_reads"), (8, "launch_only")):
            def run():  # sgd_epoch_step's launch, with ``knock``
                uk._build.check("umap_sgd_epoch", uk._k10_launch(
                    emb, emb, rows, tails, p, perm, offs, None, seed, None, nxt, 1.577, 0.895, 1.0, 2.0, 1.0,
                    knock=knock))

            out[name][what] = device_host(torch, run, 50)[0]
    return out


def traverse_probe(torch, args, dev) -> int:
    """``--traverse-only``: K9's checks alone with random forests (no fits,
    no sketch): its four timed shapes (the bench forest on the forest rows
    made from ``--seed`` and binned as the forest phase bins them), each
    held bit for bit with its controls and timed, the route gate, then the
    ragged shapes."""
    from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
    from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt

    X, _ = make_data(torch, RF_ROWS, RF_ROWS, args.seed, dev)
    bins = rf_bins(torch, pt, X, args.seed)
    del X
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 19)
    rng = np.random.default_rng(args.seed + 19)
    reps = max(args.reps, 10)
    res = phase_k9(torch, rk, pt, g, rng, reps, bench_bins=bins)
    out = {"probe": "packed_forest_eval", "package": rk.__file__,
           "shapes": {k: {m: v for m, v in r.items() if m != "controls"} for k, r in res.items()}}
    emit(out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12_000_000, help="end-to-end rows (N x 256 f32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3, help="timed calls per kernel measurement")
    ap.add_argument("--subset", type=int, default=100_000, help="rows of the card-vs-CPU fits")
    ap.add_argument("--gather-only", action="store_true",
                    help="a probe: build K7/K8 alone and run only their kernel phase (prints no result line)")
    ap.add_argument("--knn-only", action="store_true",
                    help="a probe: build K4 alone and run only its kernel phase (prints no result line)")
    ap.add_argument("--kmeans-only", action="store_true",
                    help="a probe: build K2 alone and run only its kernel phase (prints no result line)")
    ap.add_argument("--hist-only", action="store_true",
                    help="a probe: build K5 and K6 alone and time their levels (prints no result line)")
    ap.add_argument("--logreg-only", action="store_true",
                    help="a probe: build K3 alone and time the route, the class-tiled instance and the cluster "
                         "kernel beside the general kernel (prints no result line)")
    ap.add_argument("--umap-only", action="store_true",
                    help="a probe: build K4 and K10 alone, run K10's checks and the two UMAP paths (prints no "
                         "result line)")
    ap.add_argument("--linreg-only", action="store_true",
                    help="a probe: build K1 alone, run its LinearRegression shapes and the three LinearRegression "
                         "paths (prints no result line)")
    ap.add_argument("--stream-only", action="store_true",
                    help="a probe: build K1, K3 and K2 alone and run only the streamed phase: the copy, streamed "
                         "vs resident fits, the 100M-row fits, the parquet scan, the streamed LogisticRegression, "
                         "the streamed KMeans, the wire formats and checkpoint/resume (prints no result line)")
    ap.add_argument("--wire-only", action="store_true",
                    help="a probe: build K1, K3 and K2 alone and run only the wire formats and checkpoint/resume "
                         "phases on min(--rows, STREAM_WIRE_ROWS) rows (prints no result line)")
    ap.add_argument("--f64-only", action="store_true",
                    help="a probe: build K1, K3 and K2 alone and run only the float64 phase on min(--rows, "
                         "F64_ROWS) rows (prints no result line)")
    ap.add_argument("--tuning-only", action="store_true",
                    help="a probe: build K1, K3, K5/K6 and K9 alone and run only the tuning phase (r) on "
                         "min(--rows, TUNING_ROWS) rows (prints no result line)")
    ap.add_argument("--ann-only", action="store_true",
                    help="a probe: build K2, K4 and K10 alone, time K2 at the IVF quantizer's shape and run the ann "
                         "and umap_ivf paths (prints no result line)")
    ap.add_argument("--traverse-only", action="store_true",
                    help="a probe: build K9 alone and run its checks at every shape with random forests, no fits "
                         "(prints no result line)")
    ap.add_argument("--sweep", action="store_true",
                    help="with --gather-only: time chunk sizes and grids too; with --knn-only: other "
                         "geometries; with --kmeans-only: the m = 0 split and stage depths; with "
                         "--hist-only: the GBT's levels 0 and 3 and the knock-outs; with --logreg-only: the "
                         "general and cluster kernels' knock-outs and the other cluster sizes; with --umap-only: "
                         "K10's knock-outs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from spark_rapids_ml_tpu_torch.ops import _build
    from spark_rapids_ml_tpu_torch.ops import logreg_kernels as lk

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in exact f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    build_s = _build.build(["rf_byte_gather"] if args.gather_only else ["knn_topk"] if args.knn_only
                           else ["lloyd_step"] if args.kmeans_only else ["rf_hist"] if args.hist_only
                           else ["logreg_loss_grad"] if args.logreg_only
                           else ["knn_topk", "umap_sgd_epoch"] if args.umap_only
                           else ["lloyd_step", "knn_topk", "umap_sgd_epoch"] if args.ann_only
                           else ["rf_traverse"] if args.traverse_only
                           else ["shifted_gram"] if args.linreg_only
                           else ["shifted_gram", "logreg_loss_grad", "rf_hist", "rf_traverse"] if args.tuning_only
                           else ["shifted_gram", "logreg_loss_grad", "lloyd_step"] if (
                               args.stream_only or args.wire_only or args.f64_only)
                           else _build.SOURCES)
    build_total = time.perf_counter() - t
    ptxas = {
        name: [ln.strip() for ln in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.SOURCES if (_build.BUILD_DIR / f"{name}.log").exists()
    }
    emit({"phase": "card", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
          "build_total_s": build_total, "ptxas": ptxas})

    if args.gather_only:
        return gather_probe(torch, args, dev)
    if args.knn_only:
        return knn_probe(torch, args, dev)
    if args.kmeans_only:
        return kmeans_probe(torch, args, dev)
    if args.hist_only:
        return hist_probe(torch, args, dev)
    if args.logreg_only:
        return logreg_probe(torch, args, dev)
    if args.umap_only:
        return umap_probe(torch, args, dev)
    if args.ann_only:
        return ann_probe(torch, args, dev)
    if args.traverse_only:
        return traverse_probe(torch, args, dev)
    if args.linreg_only:
        return linreg_probe(torch, args, dev)
    if args.stream_only:
        return stream_probe(torch, args, dev)
    if args.wire_only:
        return wire_probe(torch, args, dev)
    if args.f64_only:
        return f64_probe(torch, args, dev)
    if args.tuning_only:
        return tuning_probe(torch, args, dev)

    # the PCA fit pads rows to its chunk multiple: the kernels see that shape
    from spark_rapids_ml_tpu_torch.feature import PCA

    n = args.rows
    csize = PCA._equal_chunk_rows(n, 1, 65_536)
    n_pca = -(-n // csize) * csize
    X, y = make_data(torch, n, n_pca, args.seed, dev)
    kern = phase_kernels(torch, X, n, args.reps, args.seed)
    gates = k3_gates(kern)
    emit({"phase": "kernels", "kernel": "logreg_loss_grad", "gates": gates})
    for name, ok in gates.items():
        check(ok, f"K3 gate {name} failed: " + json.dumps(
            {k: {m: kern[k].get(m) for m in ("variant", "ms", "plain_ms")} for k in kern if k.startswith("logreg")}))
    kern.update(phase_lloyd_kernels(torch, X[:n], args.reps, args.seed))
    gates = lloyd_gates(kern)
    emit({"phase": "kernels", "kernel": "lloyd_step", "gates": gates, "ms_max": LLOYD_MS_MAX})
    for name, ok in gates.items():
        check(ok, f"K2 gate {name} failed: " + json.dumps(
            {k: {m: kern[k][m] for m in ("ms", "plain_ms", "library_ms")} for k in ("lloyd_step", "lloyd_step_4097")}))
    X_umap = make_umap_data(UMAP_ROWS, args.seed)
    X_cluster = make_cluster_data(torch, args.seed, dev)
    ni = min(KNN_ITEMS, n)
    kern.update(phase_knn_umap_kernels(torch, X[:ni], X_umap, X_cluster, args.reps, args.seed))
    kern.update(phase_rf_kernels(torch, X[:min(RF_ROWS, n)], y[:min(RF_ROWS, n)], args.reps, args.seed))
    gates = node_hist_gates(kern)
    emit({"phase": "kernels", "kernel": "node_hist_batched", "gates": gates, "ms_max": NODE_HIST_MS_MAX})
    for name, ok in gates.items():
        check(ok, f"K5 gate {name} failed: " + json.dumps(
            {k: {m: kern[k][m] for m in ("ms", "plain_ms", "library_ms")} for k in NODE_HIST_SHAPES}))
    gates = node_hist_sel_gates(kern)
    emit({"phase": "kernels", "kernel": "node_hist_sel_batched", "gates": gates})
    for name, ok in gates.items():
        check(ok, f"K6 gate {name} failed: " + json.dumps(
            {k: {m: kern[k][m] for m in ("ms", "route_b_ms", "library_ms")} for k in NODE_HIST_SEL_SHAPES}))
    # LinearRegression's labels and f64 references, from the rows on the card
    lin_data = linreg_data(torch, X[:n], args.seed)
    pca_ref = pca_reference(torch, X[:n])
    X_host = X[:n].cpu().numpy()
    y_host = y.cpu().numpy()
    del X, y
    torch.cuda.empty_cache()
    # each path runs with the launch counters zeroed just before it and
    # read just after: {kernel: {path: launches}}
    e2e_launches, km_resident = phase_e2e(torch, X_host, y_host, args.seed)
    by_path = {key: {"pca_kmeans_logreg": c} for key, c in e2e_launches.items()}
    phase_subset(torch, X_host, y_host, args.seed, min(args.subset, n))
    by_path["logreg_loss_grad"]["logreg10_card_vs_cpu"] = phase_logreg10_subset(
        torch, X_host, args.seed, min(args.subset, n))
    Xw, yw, oracle = wide_data(X_host, args.seed)
    by_path["logreg_loss_grad_tile"] = {"logreg_wide": phase_logreg_wide(torch, Xw, yw, oracle),
                                        "logreg_wide_card_vs_cpu": phase_logreg_wide_subset(
                                            torch, Xw, yw, min(LOGREG_WIDE_SUBSET, Xw.shape[0]))}
    del Xw, yw
    Xm, ym, oracle = many_data(torch, X_host, args.seed)
    by_path["logreg_loss_grad_route"] = {"logreg_many": phase_logreg_many(torch, Xm, ym, oracle),
                                         "logreg_many_card_vs_cpu": phase_logreg_many_subset(
                                             torch, Xm, ym, min(LOGREG_MANY_SUBSET, Xm.shape[0]))}
    del Xm, ym
    X1, y1, oracle = onek_data(torch, X_host, args.seed)
    rows_1k = min(LOGREG_1K_SUBSET, X1.shape[0])
    # the route's launches by path, its class-tiled instance's among them
    by_path["logreg_loss_grad_route"].update({
        "logreg_1k": phase_logreg_1k(torch, X1, y1, oracle),
        "logreg_1k_card_vs_cpu": sum(phase_logreg_many_subset(
            torch, X1, y1, rows_1k, "logreg_1k", LOGREG_1K_CLASSES, {lk._ROUTE_TILED}, reg, hold_coef)
            for reg, hold_coef in ((1e-5, False), (LOGREG_1K_SUBSET_REG, True)))})
    del X1, y1
    Xr, yr, oracle = wide_data(X_host, args.seed, LOGREG_REALSIM_D, LOGREG_REALSIM_ROWS, salt=16)
    realsim = k3_key(*K3_CLUSTER_SHAPES[1])
    code = lk._k3_variant(LOGREG_REALSIM_D, 1, False)
    by_path["logreg_loss_grad_cluster"] = {
        "logreg_realsim": phase_logreg_realsim(torch, Xr, yr, oracle, kern[realsim].get("ms") if Xr.shape[0] == (
            LOGREG_REALSIM_ROWS) else None),
        "logreg_realsim_card_vs_cpu": sum(phase_logreg_many_subset(
            torch, Xr, yr, min(LOGREG_REALSIM_SUBSET, Xr.shape[0]), "logreg_realsim", 2, {code}, reg, hold_coef,
            "the cluster kernel") for reg, hold_coef in ((1e-5, False), (LOGREG_1K_SUBSET_REG, True)))}
    del Xr, yr
    by_path["shifted_gram"].update(linreg_paths(torch, X_host, lin_data, args.subset, args.seed))
    by_path["shifted_gram"]["streamed"], k1_chunk, k3_stream, k3_launches, k2_stream, k2_launches = phase_streamed(
        torch, X_host, y_host, lin_data["linreg"], pca_ref, args.seed, km_resident)
    kern.update(k3_stream)
    kern.update(k2_stream)
    for row, paths in list(k3_launches.items()) + list(k2_launches.items()):
        by_path.setdefault(row, {}).update(paths)
    del lin_data, pca_ref
    for row, paths in phase_f64(torch, X_host, args.seed).items():
        by_path.setdefault(row, {}).update(paths)
    tuning_launches = phase_tuning(torch, X_host, args.seed)
    by_path["knn_topk"] = {"knn": phase_knn_e2e(torch, X_host[:ni])}
    for path, launches in umap_paths(torch, X_umap, X_cluster, args.seed).items():
        for key, count in launches.items():
            by_path.setdefault(key, {})[path] = count
    # the IVF paths: K2 at the quantizer's shape has a row of its own
    X_ann = make_ann_data(args.seed)
    kern["lloyd_step_ivf_quantizer"] = phase_ivf_quantizer_k2(torch, X_ann, args.seed)
    t_ivf = time.perf_counter()
    ivf_launches, k10_calls = ivf_paths(torch, X_ann, args.seed)
    ivf_paths_s = time.perf_counter() - t_ivf
    # K10 at the umap_ivf path's own shapes, on the rows it gave K10
    kern.update(phase_umap_ivf_sgd(torch, k10_calls, args.reps, args.seed))
    del k10_calls
    for path, launches in ivf_launches.items():
        for key, count in launches.items():
            if count:
                by_path.setdefault("lloyd_step_ivf_quantizer" if key == "lloyd_step" else key, {})[path] = count
    del X_ann
    rf_paths = phase_rf_e2e(torch, X_host, y_host, args.seed)
    phase_rf_profile(torch, X_host, y_host, args.seed)
    rf_subset = phase_rf_subset(torch, X_host, y_host, args.seed, min(RF_SUBSET_ROWS, n))
    gbt_paths = phase_gbt_e2e(torch, X_host, y_host, args.seed)
    gbt_subset = phase_gbt_subset(torch, X_host, y_host, args.seed, min(RF_SUBSET_ROWS, n))
    for name in RF_WRAPPERS:
        by_path[name] = {path: c for paths in (rf_paths[name], gbt_paths[name]) for path, c in paths.items() if c}
        for path, sub in (("rf_card_vs_cpu", rf_subset), ("gbt_card_vs_cpu", gbt_subset)):
            if sub[name]:
                by_path[name][path] = sub[name]
    # the tuning phase's launches, each kernel's in its main-shape row
    for row, count in tuning_launches.items():
        by_path.setdefault(row, {})["tuning"] = count

    b = kern["packed_forest_eval"]
    kern["packed_traverse"] = {**{k: b[k] for k in ("rows", "trees", "t_pad", "d_pad", "words", "depth", "k1", "k2")},
                               **b["i1"], "max_abs_err": 0}
    # name -> (TPU kernel's pallas_call, key of the measurement, source file)
    sources = {
        "shifted_gram": ("spark_rapids_ml_tpu/ops/linalg.py:141", "shifted_gram", "shifted_gram"),
        "lloyd_step": ("spark_rapids_ml_tpu/ops/kmeans_pallas.py:174", "lloyd_step", "lloyd_step"),
        "logreg_loss_grad": ("spark_rapids_ml_tpu/ops/logreg_pallas.py:152", "logreg_loss_grad",
                             "logreg_loss_grad"),
        "knn_topk": ("spark_rapids_ml_tpu/ops/knn_pallas.py:160", "knn_topk", "knn_topk"),
        "node_hist_batched": ("spark_rapids_ml_tpu/ops/rf_pallas.py:190", "node_hist_batched", "rf_hist"),
        # K6 at the 131,072-row level 12 (its other shapes: extra_shapes)
        "node_hist_sel_batched": ("spark_rapids_ml_tpu/ops/rf_pallas.py:312", "node_hist_sel_batched", "rf_hist"),
        # K9 from the root with its payload sum at the bench forest's batch
        # (its other shapes: extra_shapes); from a given hop 1 (the TPU
        # kernel's contract): no caller on a path, its held measurement
        "packed_forest_eval": ("spark_rapids_ml_tpu/ops/rf_pallas.py:676", "packed_forest_eval", "rf_traverse"),
        "packed_traverse": ("spark_rapids_ml_tpu/ops/rf_pallas.py:676", "packed_traverse", "rf_traverse"),
        "packed_byte_gather_many": ("spark_rapids_ml_tpu/ops/rf_pallas.py:727", "packed_byte_gather_many",
                                    "rf_byte_gather"),
        # no caller in either package: its held measurement, no launches
        "packed_byte_gather": ("spark_rapids_ml_tpu/ops/rf_pallas.py:507", "packed_byte_gather", "rf_byte_gather"),
    }
    kernels = []
    for name, (replaces, key, src) in sources.items():
        r = kern[key]
        entry = {
            "name": name, "route": "cuda",
            "source": f"spark_rapids_ml_tpu_torch/csrc/{src}.cu", "replaces": replaces,
            # the sum over the paths that run the kernel, each counted alone
            "launches": sum(by_path[key].values()), "launches_by_path": by_path[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # K2, K4: the FP32 bound beside bound_ms, the 3xTF32 tensor-core one
            **{k: r[k] for k in ("bound_f32_ms",) if k in r},
            # K6: route B's time (the subset gather and K5) beside its own
            **{k: r[k] for k in ("route_b_ms", "sectors_a_row", "launches_a_level") if k in r and name == (
                "node_hist_sel_batched")},
            # K7/K8: device time and host cost apart, and the routed instance
            **{k: r[k] for k in ("device_ms", "library_device_ms", "host_us", "variant") if k in r and name in (
                "packed_byte_gather_many", "packed_byte_gather")},
            "shape": {k: r[k] for k in ("n", "d", "k", "K", "nq", "ni", "R", "C", "neg", "n_tab", "T", "level", "F",
                                        "n_nodes",
                                        "n_pad", "r_sub", "S", "nb", "k_pad", "d_pad", "rows", "trees", "t_pad",
                                        "k1", "k2", "words", "G", "variant", "BM", "stages", "slab", "blocks", "mode",
                                        "depth", "V")
                      if k in r},
        }
        kernels.append(entry)
    kernels += k10_entries(kern, by_path)
    # K2 at the streamed KMeans' chunk shapes: the launches of the streamed
    # fits' Lloyd and cost passes (k = 1,024 on the 12M rows, 1,000 at
    # 100M) and of the k-means|| candidate-count pass (k ~ 4,097)
    for name in k2_stream:
        r = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "spark_rapids_ml_tpu_torch/csrc/lloyd_step.cu",
            "replaces": sources["lloyd_step"][0], "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bound_f32_ms": r["bound_f32_ms"], "last_chunk": r["last_chunk"],
            # the candidate-count row: the counts its main-path launches ran at
            **{k: r[k] for k in ("main_path_k",) if k in r},
            "shape": {k: r[k] for k in ("n", "d", "k")}})
    # K2 at the IVF coarse quantizer's shape: the launches of the index
    # builds of the ann and umap_ivf paths
    r = kern["lloyd_step_ivf_quantizer"]
    kernels.append({
        "name": "lloyd_step_ivf_quantizer", "route": "cuda", "source": "spark_rapids_ml_tpu_torch/csrc/lloyd_step.cu",
        "replaces": sources["lloyd_step"][0], "launches": sum(by_path["lloyd_step_ivf_quantizer"].values()),
        "launches_by_path": by_path["lloyd_step_ivf_quantizer"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "bound_f32_ms": r["bound_f32_ms"], "shape": {k: r[k] for k in ("n", "d", "k")}})
    # K3's tile kernel at the wide fit's shape (the launches of the wide
    # paths), and timed beside its autograd call at the general route's
    # three shapes; the route past the tile kernel's cap at the
    # logreg_many fit's shape (the launches of its paths) and at its other
    # three timed shapes; its class-tiled instance at the logreg_1k fit's
    # shape (the launches of its paths) and at its other three; the
    # cluster kernel at the logreg_realsim fit's shape (the launches of its
    # paths) and at its other three timed shapes; the general kernel at
    # the shape it keeps. No other path launches these shapes, and each
    # launch counts in the one row whose kernel ran it.
    many, onek = k3_key(*K3_ROUTE_SHAPES[-1]), k3_key(LOGREG_1K_ROWS, LOGREG_1K_D, LOGREG_1K_CLASSES)
    route = by_path["logreg_loss_grad_route"]
    k3_rows = [("logreg_loss_grad_tile", "logreg_loss_grad_tile_wide", by_path["logreg_loss_grad_tile"]),
               ("logreg_loss_grad_route", many, {p: c for p, c in route.items() if p.startswith("logreg_many")}),
               ("logreg_loss_grad_route_tiled", onek, {p: c for p, c in route.items() if p.startswith("logreg_1k")}),
               ("logreg_loss_grad_cluster", realsim, by_path["logreg_loss_grad_cluster"])]
    # K3 at the streamed LogisticRegression's three chunk shapes (the
    # launches of the streamed fits)
    k3_rows += [(name, name, by_path[name]) for name in k3_stream]
    k3_rows += [(k3_key(K3_GENERAL_ROWS, d_r, K_r), k3_key(K3_GENERAL_ROWS, d_r, K_r), {})
                for d_r, K_r in K3_GENERAL_SHAPES]
    k3_rows += [(k3_key(*shape), k3_key(*shape), {})
                for shape in K3_ROUTE_SHAPES + K3_TILED_SHAPES + K3_CLUSTER_SHAPES + K3_GENERAL_KEPT
                if k3_key(*shape) not in (many, onek, realsim)]
    for name, key, paths in k3_rows:
        r = kern[key]
        kernels.append({
            "name": name, "route": "cuda", "source": "spark_rapids_ml_tpu_torch/csrc/logreg_loss_grad.cu",
            "replaces": sources["logreg_loss_grad"][0], "launches": sum(paths.values()), "launches_by_path": paths,
            "variant": r["variant"], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("bound_f32_ms", "general_ms") if k in r},
            "shape": {k: r[k] for k in ("n", "d", "K")}})
    extra = {"shifted_gram_sqrt_w": kern["shifted_gram_sqrt_w"], "shifted_gram_wide": kern["shifted_gram_wide"],
             "shifted_gram_stream_chunk": k1_chunk,
             "lloyd_step_k4097": kern["lloyd_step_4097"], "logreg_loss_grad_K10": kern["logreg_loss_grad_10"],
             "knn_topk_join": kern["knn_topk_join"], "knn_topk_umap_graph": kern["knn_topk_umap_graph"],
             "knn_topk_umap_transform": kern["knn_topk_umap_transform"],
             "umap_sgd_epoch_transform": kern["sgd_epoch_transform"],
             "umap_sgd_epoch_generic_transform": kern["sgd_epoch_cluster_transform"],
             "node_hist_bench_level2": kern["node_hist_level2"],
             "node_hist_regressor_level12": kern["node_hist_variance"],
             "node_hist_gbt_level7": kern["node_hist_gbt"], "node_hist_gbt_level0": kern["node_hist_gbt_level0"],
             "node_hist_gates": node_hist_gates(kern),
             "node_hist_sel_wide_level2": kern["node_hist_sel_level2"],
             "node_hist_sel_reference_rows_level12": kern["node_hist_sel_ref"],
             "node_hist_sel_gates": node_hist_sel_gates(kern),
             "packed_byte_gather_many_gbt": kern["packed_byte_gather_many_gbt"],
             "packed_byte_gather_many_wide": kern["packed_byte_gather_many_wide"],
             **{key: kern[key] for key, *_ in K9_SHAPES[1:]}}
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "ivf_paths_s": ivf_paths_s, "extra_shapes": extra,
          "launches_by_path": by_path})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
